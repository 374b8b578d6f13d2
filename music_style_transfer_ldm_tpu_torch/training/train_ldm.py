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

Data parallelism (``parallel/``): under a process group each rank holds
one card and its slice of every global batch.  The step draws t, the
noise and the style-drop mask for the whole global batch (row i takes
draw i) and keeps its rows, so an N-rank step computes what one process
computes on that batch.  Pad rows weigh 0 in the losses and in the decoder's
BatchNorm statistics, which the layer takes over every rank; the loss
backpropagated is world x (the rank's weighted sum) / (the global sum of
weights), so DistributedDataParallel's gradient mean is the gradient of
the global loss.  Rank 0 alone writes checkpoints, ``metrics.csv`` and
plots.

On an (n, m) mesh (``config.mesh.mesh_shape``, n x m ranks) the model's
layers split over the model axis (``parallel/sharding.py``): tensor
parallelism, or with ``config.mesh.sequence_parallel`` sequence
parallelism, where each rank takes its block of the batch's width and
the model's outputs and the losses are whole on every peer.  Rows,
draws and loss weights are keyed by the data index (model peers hold the
same rows); the noise is drawn for the batch's whole latent width.  A
checkpoint holds the whole tensors (gathered; every rank of the model
group calls the save, rank 0 writes) and loads into any mesh.
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
from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    DataParallel, all_reduce_mean, barrier, gather, global_loss_weights,
    is_main, model_axis,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    shard_params, step_rows, sync_replicated, training_mesh,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt_lib
from music_style_transfer_ldm_tpu_torch.training.metrics import MetricLogger
from music_style_transfer_ldm_tpu_torch.training.optim import (
    freeze_encoder, make_optimizer, plateau_init, plateau_update,
    set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, as_unit_images, ema_params_of, ema_update,
    prefetch_to_device,
)
from music_style_transfer_ldm_tpu_torch.utils.profiling import (
    StallWatchdog, span,
)

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
    from its seed.  ``mesh`` (``parallel/``): by default the process
    group's ranks when one is started (each rank on its own card, which
    ``device`` then does not change), else ``device`` alone."""

    def __init__(self, config, mesh=None, perceptual: bool = True,
                 device="cuda", feature_impl: str = "auto",
                 compression_feature_params: Optional[dict] = None,
                 style_feature_params: Optional[dict] = None):
        self.config = config
        self.mesh = training_mesh(config.mesh, mesh, device)
        self.device = self.mesh.device
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
        # the model axis (None at m = 1) and the BatchNorm statistics'
        # group: the data group, or every rank when the width is split
        self.ax = model_axis(self.mesh, config.mesh.sequence_parallel)
        self.sequence_parallel = self.ax is not None and self.ax.sequence
        self.stats_group = (self.mesh.group if self.sequence_parallel
                            else self.mesh.data_group)
        # the module a step runs: DistributedDataParallel under a group
        self.train_model = DataParallel(self.mesh)

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
        from the transplanted weights.  On a mesh every rank starts from
        rank 0's weights, split over the model axis (``shard_params``)."""
        model = build_ldm(self.config, dtype=torch.float32,
                          device=self.device, seed=seed)
        if pretrained_autoencoder is not None:
            ae = pretrained_autoencoder["params"]
            model.encoder.load_state_dict(ae["encoder"])
            model.decoder.load_state_dict(ae["decoder"])
        shard_params(model, self.mesh)
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
                style_drop_mask: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total, metrics) of one batch; NHWC images in [0, 1] (or uint8),
        t [B], noise NHWC latents, ``weights`` [B] validity (0 for a pad
        row).  Updates the decoder's BatchNorm running statistics (train
        mode), as the step does.  Under a process group the values are
        this rank's share: their mean over the data indices is the global
        weighted loss.  Under sequence parallelism content and style are
        this rank's width blocks and ``noise`` the whole width's; the
        losses run on whole images."""
        content = as_unit_images(content)
        style = as_unit_images(style)
        w, scale = global_loss_weights(weights, self.mesh)
        with self._autocast():
            out = model(content, style, t, train=True, frozen_encoder=True,
                        style_drop_mask=style_drop_mask, noise=noise,
                        sample_weights=weights, group=self.stats_group,
                        ax=self.ax)
            if self.sequence_parallel:
                content, style = (gather(x, 2, self.ax)
                                  for x in (content, style))
            comp = (self.compression_feature.distance
                    if self.compression_feature is not None else None)
            denoising = diffusion_loss(out["noise_pred"], out["noise"], w)
            compression = compression_loss(
                content, out["reconstructed"], out["z_0"], comp,
                self.perceptual_weight, self.kl_weight, weights=w)
            if self.style_feature is not None:
                with torch.set_grad_enabled(
                        torch.is_grad_enabled()
                        and not self.style_loss_stop_gradient):
                    style_l = style_loss(out["reconstructed"], style,
                                         self.style_feature.distance, w)
            else:
                style_l = torch.zeros((), device=content.device)
        total = compression + denoising + self.style_loss_weight * style_l
        metrics = {"total_loss": total, "compression_loss": compression,
                   "denoising_loss": denoising, "style_loss": style_l}
        if scale is not None:
            total = total * scale
            metrics = {k: v * scale for k, v in metrics.items()}
        return total, {k: v.detach().float() for k, v in metrics.items()}

    def latent_shape(self, content: torch.Tensor) -> Tuple[int, int, int]:
        """The NHWC latent (H / 8, W / 8, latent_dim) of a batch of
        ``content`` [B, H, W, 1] as passed (this rank's width block under
        sequence parallelism: W is then the whole padded width)."""
        width = content.shape[2] * (self.ax.size if self.sequence_parallel
                                    else 1)
        return (content.shape[1] // 8, width // 8,
                self.config.model.latent_dim)

    def draws(self, step: int, batch: int,
              t: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              style_drop_mask: Optional[torch.Tensor] = None,
              latent_shape: Optional[Tuple[int, int, int]] = None):
        """(t, noise, style-drop mask or None) of step ``step`` for this
        data index's ``batch`` rows: those not given are drawn, in that
        order, from a generator seeded by ``step_seed(seed, step)`` for
        rows 0 .. max(configured batch, padded global batch) - 1, and this
        data index's rows kept.  Row i of a global batch takes draw i
        whatever the batch's length, so a short batch split over ranks
        with pad rows draws what one process draws for it unpadded.  The
        noise has the batch's NHWC ``latent_shape`` (default the square
        latent of ``image_size``)."""
        cfg, dev, gen, mesh = self.config, self.device, self.generator, \
            self.mesh
        n = max(cfg.train.batch_size, batch * mesh.data_size)
        rows = slice(mesh.data_index * batch, (mesh.data_index + 1) * batch)
        gen.manual_seed(step_seed(cfg.train.seed, step))
        if t is None:
            t = torch.randint(0, cfg.diffusion.num_timesteps, (n,),
                              device=dev, generator=gen)[rows]
        if noise is None:
            lat = cfg.model.image_size // 8
            shape = latent_shape or (lat, lat, cfg.model.latent_dim)
            noise = torch.randn((n, *shape), device=dev,
                                generator=gen)[rows]
        p_drop = float(cfg.train.style_dropout)
        if style_drop_mask is None and p_drop > 0.0:
            style_drop_mask = (torch.rand(n, device=dev, generator=gen)
                               < p_drop).float()[rows]
        return t, noise, style_drop_mask

    def _step(self, state: TrainState, content: torch.Tensor,
              style: torch.Tensor, t: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              style_drop_mask: Optional[torch.Tensor] = None,
              weights: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on this rank's rows (``weights`` their
        validity, None when none is padded); t, noise and the style-drop
        mask are this rank's rows of ``draws`` unless given.  The metrics
        are the global batch's, on the device.  Traced as ``train.draws``,
        then ``train.forward``, ``train.backward`` and ``train.optimizer``
        (sync, step, EMA), the last three on the device too."""
        dev = self.device
        with span("train.draws"):
            t, noise, style_drop_mask = self.draws(
                state.step, content.shape[0], t, noise, style_drop_mask,
                self.latent_shape(content))
        state.optimizer.zero_grad(set_to_none=True)
        # weights by keyword only when given: one process without pad
        # rows calls _losses exactly as before
        kw = {} if weights is None else {"weights": weights}
        with span("train.forward", device=dev):
            total, metrics = self._losses(self.train_model(state.model),
                                          content, style, t, noise,
                                          style_drop_mask, **kw)
        with span("train.backward", device=dev):
            total.backward()
        with span("train.optimizer", device=dev):
            sync_replicated(state.model, self.ax)
            state.optimizer.step()
            ema = state.ema_params
            if ema is not None:
                ema = ema_update(ema, state.model, self.ema_decay,
                                 state.step)
        if self.mesh.distributed:
            vec = all_reduce_mean(torch.stack(
                [metrics[k] for k in METRIC_KEYS]), self.mesh)
            metrics = dict(zip(METRIC_KEYS, vec.unbind()))
        return TrainState(state.model, state.optimizer, state.step + 1,
                          ema), metrics

    # ---------------- epochs -----------------------------------------------

    def train_epoch(self, state: TrainState, loader
                    ) -> Tuple[TrainState, Dict[str, float]]:
        """One pass over ``loader``; per-step metrics stay on the device
        and are read once, at the end (a read per step would stall the
        launch queue).  Under a process group the loader yields this
        process's slice of each global batch (``process_count`` = the
        world size), or whole global batches that are split here."""
        mesh = self.mesh

        def place(item):
            i, ((content, _), (style, _)) = item
            (content, style), w = step_rows((content, style), mesh, loader,
                                            i, self.sequence_parallel)
            return content, style, w

        collected = []
        for content, style, w in prefetch_to_device(enumerate(loader),
                                                    place):
            state, metrics = self._step(state, content, style, weights=w)
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
        counting epochs from its step (every rank loads it onto its own
        card); rank 0 alone writes, with a barrier after each write."""
        cfg = self.config.train
        num_epochs = num_epochs or cfg.num_epochs
        out_dir = Path(out_dir)
        if state is None:
            state = self.init_state(cfg.seed, pretrained_autoencoder)
        start_epoch = 0
        if resume_from is not None:
            state = ckpt_lib.restore_train_state(resume_from, state,
                                                 self.mesh)
            start_epoch = state.step // max(len(train_loader), 1)
        main = is_main(self.mesh)
        logger = (MetricLogger(out_dir / "metrics.csv",
                               resume=resume_from is not None,
                               truncate_from_epoch=start_epoch)
                  if main else None)
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            with StallWatchdog(timeout_s=600, context=f"LDM epoch {epoch} "
                               f"(checkpoints under {out_dir})"):
                state, avgs = self.train_epoch(state, train_loader)
            self.plateau = plateau_update(self.plateau, avgs["total_loss"])
            set_learning_rate(state.optimizer, self.plateau.lr)
            if main:
                logger.log(epoch=epoch, lr=self.plateau.lr,
                           seconds=time.time() - t0, **avgs)
            if epoch % cfg.ckpt_every_epochs == 0:
                ckpt_lib.save_train_state(out_dir / f"ldm_{epoch}.pt",
                                          state, mesh=self.mesh)
                if main:
                    keys = list(METRIC_KEYS)
                    logger.plot(out_dir / f"ldm_loss_{epoch}.png", keys)
                    logger.plot(out_dir / f"ldm_loss_log_{epoch}.png", keys,
                                logscale=True)
                barrier(self.mesh)
        ckpt_lib.save_train_state(out_dir / "ldm_final.pt", state,
                                  mesh=self.mesh)
        barrier(self.mesh)
        return state
