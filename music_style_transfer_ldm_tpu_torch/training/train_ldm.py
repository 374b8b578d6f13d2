"""Latent diffusion training (the LDM phase).

The reference recipe starts it from phase 1's autoencoder
(``training/train_autoencoder.py``): ``init_state(pretrained_autoencoder=)``
copies its encoder and decoder in, and the encoder stays frozen.  One
step: draw t ~ U{0..T-1}, the q-sample noise and the style-dropout
mask (each may be given instead) from a generator re-seeded from
(``TrainConfig.seed``, step), so a run resumed from a checkpoint draws
what the uninterrupted run drew; then the training forward with the encoder
frozen on its running BatchNorm statistics and the decoder's BatchNorm
in train mode, the three losses, backward, Adam over the non-encoder
parameters, and the EMA.  On the card the model computes in bf16 under
``torch.autocast`` (``TrainConfig.compute_dtype``) with f32 parameters
and f32 losses; on the CPU everything is f32 and the kernels' plain
versions run.

The style term is the VGGish distance (``losses/vggish.py``).  Under
``style_loss_stop_gradient`` (the default) it is computed under
``torch.no_grad()``, so on the card it goes through the trunk kernel's
value-only variant (kernel E, with kernel D's per-layer metrics); with
the gradient on, through kernel E with grad.  With
``compression_feature_extractor="vggish"`` the compression term's
perceptual distance needs the gradient of its target input (the
reconstruction), so it takes the per-layer route (kernel D).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from music_style_transfer_ldm_tpu_torch.losses.basic import (
    compression_loss, diffusion_loss, style_loss,
)
from music_style_transfer_ldm_tpu_torch.losses.feature import (
    build_feature_metric,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt_lib
from music_style_transfer_ldm_tpu_torch.training.metrics import MetricLogger
from music_style_transfer_ldm_tpu_torch.training.optim import (
    freeze_encoder, make_optimizer, plateau_init, plateau_update,
    set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, as_unit_images, ema_params_of, ema_update,
    prefetch_to_device, to_device,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device
from music_style_transfer_ldm_tpu_torch.utils.profiling import StallWatchdog

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """The 64-bit seed of one step's draws: splitmix64 of (seed, step),
    the counterpart of the JAX trainer's fold_in of the step into its
    base key."""
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


METRIC_KEYS = ("total_loss", "compression_loss", "denoising_loss",
               "style_loss")


class LDMTrainer:
    """Trains the LDM on (content, style) pairs.

    ``feature_impl`` is the VGGish implementation of both perceptual
    metrics (``auto``: the kernels on the card; ``plain`` forces the plain
    versions, for comparisons).  ``compression_feature_params`` and
    ``style_feature_params`` are transplanted weights of the two metrics
    (state dicts of their modules); without them each is a random trunk
    from its seed."""

    def __init__(self, config, perceptual: bool = True, device="cuda",
                 feature_impl: str = "auto",
                 compression_feature_params: Optional[dict] = None,
                 style_feature_params: Optional[dict] = None):
        self.config = config
        self.device = resolve_device(device)
        ct = config.train
        on_card = self.device.type == "cuda"
        self.compute_dtype = (getattr(torch, ct.compute_dtype) if on_card
                              else torch.float32)
        self.compression_feature = (build_feature_metric(
            ct.compression_feature_extractor, self.compute_dtype,
            seed=ct.seed + 2, device=self.device, impl=feature_impl,
            params=compression_feature_params) if perceptual else None)
        self.style_feature = (build_feature_metric(
            "vggish", self.compute_dtype, seed=ct.seed + 3,
            device=self.device, impl=feature_impl,
            params=style_feature_params) if perceptual else None)
        self.style_loss_stop_gradient = ct.style_loss_stop_gradient
        self.style_loss_weight = ct.style_loss_weight
        self.perceptual_weight = ct.perceptual_weight
        self.kl_weight = ct.kl_weight
        self.ema_decay = float(ct.ema_decay)
        self.plateau = plateau_init(ct.learning_rate, factor=ct.lr_factor,
                                    patience=ct.ldm_lr_patience,
                                    min_lr=ct.lr_min)
        self.generator = torch.Generator(device=self.device)

    # ---------------- state ------------------------------------------------

    def init_state(self, seed: int = 0,
                   pretrained_autoencoder: Optional[dict] = None
                   ) -> TrainState:
        """A fresh model (weights from ``seed``) with the encoder frozen,
        its optimizer and, when EMA is on, the EMA seeded from the init.

        ``pretrained_autoencoder`` (``checkpoint.load_autoencoder``'s
        payload, phase 1's result) replaces the encoder's and decoder's
        parameters and BatchNorm statistics before the encoder is frozen
        and before the optimizer and the EMA are made, so the EMA starts
        from the transplanted weights."""
        model = build_ldm(self.config, dtype=torch.float32,
                          device=self.device, seed=seed)
        if pretrained_autoencoder is not None:
            ae = pretrained_autoencoder["params"]
            model.encoder.load_state_dict(ae["encoder"])
            model.decoder.load_state_dict(ae["decoder"])
        params = freeze_encoder(model)
        optimizer = make_optimizer("adam", params,
                                   self.config.train.learning_rate)
        ema = ema_params_of(model) if self.ema_decay > 0.0 else None
        return TrainState(model=model, optimizer=optimizer, step=0,
                          ema_params=ema)

    def _autocast(self):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    # ---------------- one step ---------------------------------------------

    def _losses(self, model, content: torch.Tensor, style: torch.Tensor,
                t: torch.Tensor, noise: Optional[torch.Tensor] = None,
                style_drop_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics) of one batch; NHWC images in [0, 1] (or uint8),
        t [B], noise NHWC latents.  Updates the decoder's BatchNorm
        running statistics (train mode), as the step does."""
        content = as_unit_images(content)
        style = as_unit_images(style)
        with self._autocast():
            out = model(content, style, t, train=True, frozen_encoder=True,
                        style_drop_mask=style_drop_mask, noise=noise)
            comp = (self.compression_feature.distance
                    if self.compression_feature is not None else None)
            denoising = diffusion_loss(out["noise_pred"], out["noise"])
            compression = compression_loss(
                content, out["reconstructed"], out["z_0"], comp,
                self.perceptual_weight, self.kl_weight)
            if self.style_feature is not None:
                with torch.set_grad_enabled(
                        torch.is_grad_enabled()
                        and not self.style_loss_stop_gradient):
                    style_l = style_loss(out["reconstructed"], style,
                                         self.style_feature.distance)
            else:
                style_l = torch.zeros((), device=content.device)
        total = compression + denoising + self.style_loss_weight * style_l
        metrics = {"total_loss": total, "compression_loss": compression,
                   "denoising_loss": denoising, "style_loss": style_l}
        return total, {k: v.detach().float() for k, v in metrics.items()}

    def _step(self, state: TrainState, content: torch.Tensor,
              style: torch.Tensor, t: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              style_drop_mask: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step; t, noise and the style-drop mask are drawn
        unless given, from the trainer's generator seeded by
        ``step_seed(seed, state.step)``.  Metrics stay on the device."""
        cfg = self.config
        batch, dev, gen = content.shape[0], self.device, self.generator
        gen.manual_seed(step_seed(cfg.train.seed, state.step))
        if t is None:
            t = torch.randint(0, cfg.diffusion.num_timesteps, (batch,),
                              device=dev, generator=gen)
        if noise is None:
            lat = cfg.model.image_size // 8
            noise = torch.randn((batch, lat, lat, cfg.model.latent_dim),
                                device=dev, generator=gen)
        p_drop = float(cfg.train.style_dropout)
        if style_drop_mask is None and p_drop > 0.0:
            style_drop_mask = (torch.rand(batch, device=dev, generator=gen)
                               < p_drop).float()
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = self._losses(state.model, content, style, t, noise,
                                      style_drop_mask)
        total.backward()
        state.optimizer.step()
        ema = state.ema_params
        if ema is not None:
            ema = ema_update(ema, state.model, self.ema_decay, state.step)
        return TrainState(state.model, state.optimizer, state.step + 1,
                          ema), metrics

    # ---------------- epochs -----------------------------------------------

    def train_epoch(self, state: TrainState, loader
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over ``loader``; per-step metrics stay on the device
        and are read once, at the end (a read per step would stall the
        launch queue)."""
        dev = self.device

        def place(batch):
            (content, _), (style, _) = batch
            return to_device(content, dev), to_device(style, dev)

        collected = []
        for content, style in prefetch_to_device(loader, place):
            state, metrics = self._step(state, content, style)
            collected.append(torch.stack([metrics[k] for k in METRIC_KEYS]))
        if not collected:
            return state, {}
        means = torch.stack(collected).mean(0).tolist()
        return state, dict(zip(METRIC_KEYS, means))

    def train(self, train_loader, num_epochs: Optional[int] = None,
              state: Optional[TrainState] = None,
              pretrained_autoencoder: Optional[dict] = None,
              out_dir: str | Path = "runs/ldm",
              resume_from: Optional[str | Path] = None) -> TrainState:
        """The loop: plateau learning rate on each epoch's train loss,
        ``ldm_<epoch>.pt`` every ``ckpt_every_epochs`` epochs (and loss
        plots where matplotlib exists), ``ldm_final.pt`` at the end.
        ``pretrained_autoencoder`` goes to ``init_state`` when no state is
        given.  ``resume_from`` continues from a train-state checkpoint,
        counting epochs from its step."""
        cfg = self.config.train
        num_epochs = num_epochs or cfg.num_epochs
        out_dir = Path(out_dir)
        if state is None:
            state = self.init_state(cfg.seed, pretrained_autoencoder)
        start_epoch = 0
        if resume_from is not None:
            state = ckpt_lib.restore_train_state(resume_from, state)
            start_epoch = state.step // max(len(train_loader), 1)
        logger = MetricLogger(out_dir / "metrics.csv",
                              resume=resume_from is not None,
                              truncate_from_epoch=start_epoch)
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            with StallWatchdog(timeout_s=600, context=f"LDM epoch {epoch} "
                               f"(checkpoints under {out_dir})"):
                state, avgs = self.train_epoch(state, train_loader)
            self.plateau = plateau_update(self.plateau, avgs["total_loss"])
            set_learning_rate(state.optimizer, self.plateau.lr)
            logger.log(epoch=epoch, lr=self.plateau.lr,
                       seconds=time.time() - t0, **avgs)
            if epoch % cfg.ckpt_every_epochs == 0:
                ckpt_lib.save_train_state(out_dir / f"ldm_{epoch}.pt", state)
                keys = list(METRIC_KEYS)
                logger.plot(out_dir / f"ldm_loss_{epoch}.png", keys)
                logger.plot(out_dir / f"ldm_loss_log_{epoch}.png", keys,
                            logscale=True)
        ckpt_lib.save_train_state(out_dir / "ldm_final.pt", state)
        return state
