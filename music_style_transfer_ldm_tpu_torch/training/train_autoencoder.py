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

Data parallelism (``parallel/``): under a process group each rank
trains on its slice of every global batch.  Pad rows weigh 0 in the loss
and in every BatchNorm's statistics, which the layers take over every
rank; the loss backpropagated is world x (the rank's weighted sum) /
(the global sum of weights), so DistributedDataParallel's gradient mean
is the gradient of the global loss, and validation renormalises the
same way.  The reported losses are the global ones, so the plateau
scheduler steps every rank alike; rank 0 alone writes.

On an (n, m) mesh (``config.mesh.mesh_shape``) the encoder's conv2/bn2
and the decoder's deconv1/bn1 split over the model axis (tensor
parallelism, ``parallel/sharding.py``; the JAX AETrainer places no batch
width-sharded, so neither does this one), rows and loss weights are keyed
by the data index, and the frozen LPIPS and VGGish trunks stay whole on
every rank.  Checkpoints hold the whole tensors.
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
from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    DataParallel, all_reduce_mean, barrier, global_loss_weights, is_main,
    model_axis,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    shard_params, step_rows, sync_replicated, training_mesh,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt_lib
from music_style_transfer_ldm_tpu_torch.training.metrics import MetricLogger
from music_style_transfer_ldm_tpu_torch.training.optim import (
    make_optimizer, plateau_init, plateau_update, set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, as_unit_images, prefetch_to_device,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import exact_float32
from music_style_transfer_ldm_tpu_torch.utils.profiling import StallWatchdog


class Autoencoder(nn.ModuleDict):
    """``encoder`` and ``decoder`` in one module whose forward is the
    pair's (what DistributedDataParallel wraps)."""

    def forward(self, x: torch.Tensor, train: bool = False,
                sample_weights: Optional[torch.Tensor] = None, group=None,
                ax=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """NCHW x -> (z, recon in [-1, 1]), NCHW."""
        z = self["encoder"](x, train, sample_weights, group, ax)
        return z, self["decoder"](z, train, sample_weights, group, ax)


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
    it the metric is a random trunk from seed 0.  ``mesh`` as in
    ``LDMTrainer``."""

    def __init__(self, config, mesh=None, perceptual: bool = True,
                 device="cuda", feature_impl: str = "auto",
                 feature_params: Optional[dict] = None):
        self.config = config
        self.mesh = training_mesh(config.mesh, mesh, device)
        self.device = self.mesh.device
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
        self.ax = model_axis(self.mesh)   # tensor parallel; None at m = 1
        # the module a step runs: DistributedDataParallel under a group
        self.train_model = DataParallel(self.mesh)

    # ---------------- state ------------------------------------------------

    def init_state(self, seed: int = 0) -> TrainState:
        """A fresh encoder and decoder (weights from ``seed``; on a mesh
        rank 0's, split over the model axis) in one module,
        ``model.encoder`` and ``model.decoder``, with AdamW over both."""
        latent = self.config.model.latent_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = Autoencoder({"encoder": SpectrogramEncoder(latent),
                                 "decoder": SpectrogramDecoder(latent)})
        model = shard_params(model.to(self.device), self.mesh)
        optimizer = make_optimizer("adamw", list(model.parameters()),
                                   self.config.train.learning_rate)
        return TrainState(model=model, optimizer=optimizer, step=0)

    # ---------------- one step ---------------------------------------------

    def _forward(self, model, x: torch.Tensor, train: bool,
                 weights: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """NHWC x in [0, 1] -> NHWC (z, recon in [-1, 1]); ``train``
        normalises with the batch's statistics (the rows ``weights``
        keeps, over every rank) and updates the running ones."""
        group = self.mesh.data_group if train else None
        z, recon = model(x.permute(0, 3, 1, 2), train, weights, group,
                         self.ax)
        return z.permute(0, 2, 3, 1), recon.permute(0, 2, 3, 1)

    def _loss(self, model, x: torch.Tensor, train: bool,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The compression loss of one NHWC batch (uint8 or [0, 1]), pad
        rows (``weights`` 0) left out; under a process group this rank's
        share, whose mean over the ranks is the global loss."""
        x = as_unit_images(x)
        w, scale = global_loss_weights(weights, self.mesh)
        z, recon = self._forward(model, x, train, weights)
        recon01 = (recon + 1.0) / 2.0
        feature = self.feature.distance if self.feature is not None else None
        loss = compression_loss(x, recon01, z, feature,
                                self.perceptual_weight, self.kl_weight,
                                weights=w)
        return loss if scale is None else loss * scale

    def _step(self, state: TrainState, x: torch.Tensor,
              weights: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, torch.Tensor]:
        """One AdamW step on this rank's rows; the (global) loss stays on
        the device."""
        state.optimizer.zero_grad(set_to_none=True)
        with exact_float32(self.device):
            loss = self._loss(self.train_model(state.model), x, train=True,
                              weights=weights)
            loss.backward()
        sync_replicated(state.model, self.ax)
        state.optimizer.step()
        return TrainState(state.model, state.optimizer,
                          state.step + 1), all_reduce_mean(loss.detach(),
                                                           self.mesh)

    @torch.no_grad()
    def _eval(self, state: TrainState, x: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (global) loss on the running statistics, no gradient, no
        update."""
        with exact_float32(self.device):
            return all_reduce_mean(self._loss(state.model, x, train=False,
                                              weights=weights), self.mesh)

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
        mesh = self.mesh
        if state is None:
            state = self.init_state(self.config.train.seed)
        start_epoch = 0
        if resume_from is not None:
            state = ckpt_lib.restore_train_state(resume_from, state, mesh)
            start_epoch = state.step // max(len(train_loader), 1)
        main = is_main(self.mesh)
        logger = (MetricLogger(out_dir / "metrics.csv",
                               resume=resume_from is not None,
                               truncate_from_epoch=start_epoch)
                  if main else None)
        dev = self.device

        def placer(loader):
            def place(item):
                i, batch = item
                x = batch[0] if isinstance(batch, tuple) else batch
                x, w = step_rows(x, mesh, loader, i)
                # weights by keyword only when given: one process
                # without pad rows calls _step and _eval as before
                return x, {} if w is None else {"weights": w}
            return place

        best_val = float("inf")
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            with StallWatchdog(timeout_s=600, context=f"AE epoch {epoch}"):
                train_losses = []
                for x, kw in prefetch_to_device(enumerate(train_loader),
                                                placer(train_loader)):
                    state, loss = self._step(state, x, **kw)
                    train_losses.append(loss)
                val_losses = [self._eval(state, x, **kw)
                              for x, kw in prefetch_to_device(
                                  enumerate(val_loader), placer(val_loader))]
                # one host read per epoch: a read per step would stall
                # the launch queue
                train_loss, val_loss = torch.stack(
                    [_mean(train_losses, dev), _mean(val_losses, dev)]
                ).tolist()
            self.plateau = plateau_update(self.plateau, val_loss)
            set_learning_rate(state.optimizer, self.plateau.lr)
            if main:
                logger.log(epoch=epoch, train_loss=train_loss,
                           val_loss=val_loss, lr=self.plateau.lr,
                           seconds=time.time() - t0)
            if val_loss < best_val:
                best_val = val_loss
                ckpt_lib.save_autoencoder(out_dir / "pretrained.pt",
                                          state.model.encoder,
                                          state.model.decoder, mesh)
                barrier(mesh)
        if main:
            logger.plot(out_dir / "autoencoder_loss.png",
                        ["train_loss", "val_loss"])
        ckpt_lib.save_autoencoder(out_dir / "pretrained_final.pt",
                                  state.model.encoder,
                                  state.model.decoder, mesh)
        ckpt_lib.save_train_state(out_dir / "train_state_final.pt",
                                  state, mesh=mesh)
        barrier(mesh)
        return state
