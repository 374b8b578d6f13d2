"""Phase 1: autoencoder pretraining.

One step: the encoder and decoder in train mode (BatchNorm on the batch's
statistics with flax semantics, the running ones updated), the
compression loss of the unit input x against recon01 = (decoder output +
1) / 2, that is MSE + perceptual_weight x the configured feature metric
+ kl_weight x the KL term of the latent, then backward and one AdamW
step.  The feature metric is called as ``distance(x, recon01)``: the
reconstruction is its *target* input, and the gradient flows there.
Validation runs the same loss on the running statistics with no
gradient.  The loop steps the plateau learning rate on the validation
loss (``TrainConfig.lr_patience``), writes ``pretrained.pt`` (an
autoencoder checkpoint, ``training/checkpoint.py``) at every new best
validation loss, and ``pretrained_final.pt`` and
``train_state_final.pt`` at the end.

Everything computes in float32, as the JAX package's AETrainer does.  On
the card each training step and validation batch runs with TF32 off for
cuDNN's convolutions (``utils/chips.py exact_float32``; cuBLAS's TF32 is
off by PyTorch's default), so the card does the CPU's float32
arithmetic up to summation order; ``chip_smoke.py`` holds the step with
the same setting.  With VGGish as the compression metric, the training
step on the card takes the per-layer route (kernel D's forward and its
target-side backward, ``losses/vggish.py resolve_impl``) and validation
the trunk kernel's value-only variant (kernel E); LPIPS is plain
PyTorch.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional, Tuple

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.losses.basic import compression_loss
from music_style_transfer_ldm_tpu_torch.losses.feature import (
    build_feature_metric,
)
from music_style_transfer_ldm_tpu_torch.models.autoencoder import (
    SpectrogramDecoder, SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt_lib
from music_style_transfer_ldm_tpu_torch.training.metrics import MetricLogger
from music_style_transfer_ldm_tpu_torch.training.optim import (
    make_optimizer, plateau_init, plateau_update, set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, as_unit_images, prefetch_to_device, to_device,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import (
    exact_float32, resolve_device,
)
from music_style_transfer_ldm_tpu_torch.utils.profiling import StallWatchdog


def _mean(losses, device) -> torch.Tensor:
    """Mean of scalar losses on ``device`` (NaN for none, as numpy's)."""
    if not losses:
        return torch.tensor(float("nan"), device=device)
    return torch.stack(losses).mean()


class AETrainer:
    """Encoder/decoder pretrainer.

    ``feature_impl`` is the VGGish implementation when VGGish is the
    compression metric (``auto``: the kernels on the card; ``plain``
    forces the plain versions, for comparisons).  ``feature_params`` is
    a state dict of the metric's module (transplanted weights); without
    it the metric is a random trunk from seed 0."""

    def __init__(self, config, perceptual: bool = True, device="cuda",
                 feature_impl: str = "auto",
                 feature_params: Optional[dict] = None):
        self.config = config
        self.device = resolve_device(device)
        ct = config.train
        self.feature = (build_feature_metric(
            ct.compression_feature_extractor, torch.float32, seed=0,
            device=self.device, impl=feature_impl, params=feature_params)
            if perceptual else None)
        self.perceptual_weight = ct.perceptual_weight
        self.kl_weight = ct.kl_weight
        self.plateau = plateau_init(ct.learning_rate, factor=ct.lr_factor,
                                    patience=ct.lr_patience,
                                    min_lr=ct.lr_min)

    # ---------------- state ------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh encoder and decoder (weights from ``seed``) in one
        module, ``model.encoder`` and ``model.decoder``, with AdamW over
        both."""
        latent = self.config.model.latent_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = nn.ModuleDict({"encoder": SpectrogramEncoder(latent),
                                   "decoder": SpectrogramDecoder(latent)})
        model = model.to(self.device)
        optimizer = make_optimizer("adamw", list(model.parameters()),
                                   self.config.train.learning_rate)
        return TrainState(model=model, optimizer=optimizer, step=0)

    # ---------------- one step ---------------------------------------------

    def _forward(self, model, x: torch.Tensor, train: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x in [0, 1] -> NHWC (z, recon in [-1, 1]); ``train``
        normalises with the batch's statistics and updates the running
        ones."""
        z = model.encoder(x.permute(0, 3, 1, 2), train=train)
        recon = model.decoder(z, train=train)
        return z.permute(0, 2, 3, 1), recon.permute(0, 2, 3, 1)

    def _loss(self, model, x: torch.Tensor, train: bool) -> torch.Tensor:
        """The compression loss of one NHWC batch (uint8 or [0, 1])."""
        x = as_unit_images(x)
        z, recon = self._forward(model, x, train)
        recon01 = (recon + 1.0) / 2.0
        feature = self.feature.distance if self.feature is not None else None
        return compression_loss(x, recon01, z, feature,
                                self.perceptual_weight, self.kl_weight)

    def _step(self, state: TrainState, x: torch.Tensor
              ) -> Tuple[TrainState, torch.Tensor]:
        """One AdamW step; the loss stays on the device."""
        state.optimizer.zero_grad(set_to_none=True)
        with exact_float32(self.device):
            loss = self._loss(state.model, x, train=True)
            loss.backward()
        state.optimizer.step()
        return TrainState(state.model, state.optimizer,
                          state.step + 1), loss.detach()

    @torch.no_grad()
    def _eval(self, state: TrainState, x: torch.Tensor) -> torch.Tensor:
        """The loss on the running statistics, no gradient, no update."""
        with exact_float32(self.device):
            return self._loss(state.model, x, train=False)

    # ---------------- epochs -----------------------------------------------

    def train(self, train_loader, val_loader,
              num_epochs: Optional[int] = None,
              state: Optional[TrainState] = None,
              out_dir: str | Path = "runs/autoencoder",
              resume_from: Optional[str | Path] = None) -> TrainState:
        """The loop.  ``resume_from`` continues from a train-state
        checkpoint (``train_state_final.pt``), counting epochs from its
        step and dropping the metric rows of the epochs it replays."""
        num_epochs = num_epochs or self.config.train.num_epochs
        out_dir = Path(out_dir)
        if state is None:
            state = self.init_state(self.config.train.seed)
        start_epoch = 0
        if resume_from is not None:
            state = ckpt_lib.restore_train_state(resume_from, state)
            start_epoch = state.step // max(len(train_loader), 1)
        logger = MetricLogger(out_dir / "metrics.csv",
                              resume=resume_from is not None,
                              truncate_from_epoch=start_epoch)
        dev = self.device

        def place(batch):
            x = batch[0] if isinstance(batch, tuple) else batch
            return to_device(x, dev)

        best_val = float("inf")
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            with StallWatchdog(timeout_s=600, context=f"AE epoch {epoch}"):
                train_losses = []
                for x in prefetch_to_device(train_loader, place):
                    state, loss = self._step(state, x)
                    train_losses.append(loss)
                val_losses = [self._eval(state, x)
                              for x in prefetch_to_device(val_loader, place)]
                # one host read per epoch: a read per step would stall
                # the launch queue
                train_loss, val_loss = torch.stack(
                    [_mean(train_losses, dev), _mean(val_losses, dev)]
                ).tolist()
            self.plateau = plateau_update(self.plateau, val_loss)
            set_learning_rate(state.optimizer, self.plateau.lr)
            logger.log(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                       lr=self.plateau.lr, seconds=time.time() - t0)
            if val_loss < best_val:
                best_val = val_loss
                ckpt_lib.save_autoencoder(out_dir / "pretrained.pt",
                                          state.model.encoder,
                                          state.model.decoder)
        logger.plot(out_dir / "autoencoder_loss.png",
                    ["train_loss", "val_loss"])
        ckpt_lib.save_autoencoder(out_dir / "pretrained_final.pt",
                                  state.model.encoder, state.model.decoder)
        ckpt_lib.save_train_state(out_dir / "train_state_final.pt", state)
        return state
