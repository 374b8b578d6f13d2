"""The composite latent diffusion model and its transfer wrappers.

``LDM`` holds the encoder, decoder, UNet and style encoder (NCHW inside).
Its public methods take and return the JAX package's NHWC layout, so a
test compares like with like.  ``LDM.forward`` is the training forward.
``content_style_transfer`` is the SDEdit product path: encode content,
noise it to t = N-1 with per-item noise, walk the grid with DDIM or
DPM-Solver++(2M) conditioned on the style pyramid, decode.
``style_ddim_sample`` generates from noise instead.  ``load_ldm`` builds
the model from a checkpoint of the port (``training/checkpoint.py``),
the ones training writes included, or from phase 1's autoencoder.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.config import Config, default_config
from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    ddim_sample, generation_time_grid, transfer_time_grid,
)
from music_style_transfer_ldm_tpu_torch.diffusion.dpm import dpm_solver_pp_2m
from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
)
from music_style_transfer_ldm_tpu_torch.models.autoencoder import (
    SpectrogramDecoder, SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.style_encoder import (
    StyleEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.unet import UNet
from music_style_transfer_ldm_tpu_torch.parallel.collectives import gather
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device
from music_style_transfer_ldm_tpu_torch.utils.profiling import span


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class LDM(nn.Module):
    """Composite model; public methods speak NHWC."""

    def __init__(self, latent_dim: int = 32, num_timesteps: int = 200,
                 beta_start: float = 1e-4, beta_end: float = 0.02,
                 unet_num_filters: int = 64, style_num_filters: int = 64):
        super().__init__()
        self.num_timesteps = num_timesteps
        self.latent_dim = latent_dim
        self.encoder = SpectrogramEncoder(latent_dim)
        self.decoder = SpectrogramDecoder(latent_dim)
        self.unet = UNet(latent_dim, latent_dim, unet_num_filters)
        self.style_encoder = StyleEncoder(style_num_filters)
        self._beta = (beta_start, beta_end)
        self._schedule: Optional[DiffusionSchedule] = None

    @property
    def device(self) -> torch.device:
        return self.unet.enc1.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.enc1.weight.dtype

    @property
    def schedule(self) -> DiffusionSchedule:
        if (self._schedule is None
                or self._schedule.alpha_bars.device != self.device):
            self._schedule = DiffusionSchedule(self.num_timesteps,
                                               *self._beta, self.device)
        return self._schedule

    # ---- component entry points (NHWC) ----------------------------------

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC input -> NCHW on the model's device, in its dtype."""
        return _nchw(x).to(device=self.device, dtype=self.dtype)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 128, 128, 1] -> [B, 16, 16, latent_dim], model dtype."""
        return _nhwc(self.encoder(self._in(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, 16, 16, latent_dim] -> [B, 128, 128, 1] in [-1, 1]."""
        return _nhwc(self.decoder(self._in(z)))

    def style_embed(self, style: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, 128, 128, 1] -> {s1..s6} NHWC maps."""
        emb = self.style_encoder(self._in(style))
        return {k: _nhwc(v) for k, v in emb.items()}

    def denoise(self, z_t: torch.Tensor, t: torch.Tensor,
                style_embedding: Dict[str, torch.Tensor]) -> torch.Tensor:
        """UNet on NHWC latents with an NHWC style pyramid."""
        emb = {k: _nchw(v) for k, v in style_embedding.items()}
        return _nhwc(self.unet(_nchw(z_t), t, emb))

    # ---- training forward ----------------------------------------------

    def forward(self, x: torch.Tensor, style: torch.Tensor, t: torch.Tensor,
                train: bool = False, frozen_encoder: bool = False,
                style_drop_mask: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                sample_weights: Optional[torch.Tensor] = None,
                group=None, ax=None) -> Dict[str, torch.Tensor]:
        """NHWC content x and style [B, 128, 128, 1], t [B] -> NHWC
        {z_t, noise, noise_pred, z_0, reconstructed}.

        frozen_encoder=True keeps the encoder's BatchNorm on its running
        statistics while the decoder's trains.  style_drop_mask [B] (1 =
        drop) zeroes the style pyramid of those samples (classifier-free
        guidance training).  ``noise`` [B, 16, 16, latent_dim] (NHWC) is
        the q-sample draw as given; otherwise it is drawn here.
        sample_weights [B] (0 for a data-parallel pad row) and ``group``
        (the process group of the statistics) go to every train-mode
        BatchNorm: the decoder's, and the encoder's unless it is frozen
        (then it normalises with its running statistics and needs
        neither).  reconstructed is f32 in [0, 1].

        ``ax`` runs the model under a model axis (``models/layers.py``).
        With sequence parallelism x and style are this rank's width
        blocks, ``noise`` is the whole width's draw, and every output
        comes back whole (gathered once; backward, this rank's slice:
        the losses on them run alike on every peer)."""
        sched = self.schedule
        x = _nchw(x).to(self.device, torch.float32)
        style = _nchw(style).to(self.device, torch.float32)
        bn = dict(sample_weights=sample_weights, group=group, ax=ax)
        z_0 = self.encoder(x, train=train and not frozen_encoder, **bn)
        emb = self.style_encoder(style, ax)
        if style_drop_mask is not None:
            keep = (1.0 - style_drop_mask.float()).reshape(-1, 1, 1, 1)
            emb = {k: v * keep.to(v.dtype) for k, v in emb.items()}
        z0 = z_0.float()
        sp = ax is not None and ax.sequence
        if noise is None:
            eps = torch.randn_like(z0)
        else:
            eps = _nchw(noise).to(z0.device, torch.float32)
            if sp:
                eps = eps.chunk(ax.size, -1)[ax.index]
        z_t = sched.q_sample_with_noise(z0, t, eps)
        noise_pred = self.unet(z_t, t, emb, ax)
        z_0_pred = sched.predict_start_from_noise(z_t, t, noise_pred.float())
        reconstructed = self.decoder(z_0_pred, train=train, **bn)
        reconstructed = (reconstructed.float() + 1.0) / 2.0
        out = {"z_t": z_t, "noise": eps, "noise_pred": noise_pred,
               "z_0": z_0, "reconstructed": reconstructed}
        if sp:
            out = {k: gather(v, -1, ax) for k, v in out.items()}
        return {k: _nhwc(v) for k, v in out.items()}

    # ---- pieces of the transfer path (NCHW inside) ----------------------

    def noised_latents(self, content: torch.Tensor, num_timesteps: int,
                       noise: Optional[torch.Tensor] = None,
                       seeds=0) -> torch.Tensor:
        """Encode NHWC content and noise it to t = num_timesteps - 1.

        ``noise`` [B, 16, 16, C] (NHWC) is used as given; otherwise each
        item draws its own from a generator seeded by its seed, so a
        request's result does not depend on its batch.  Returns the f32
        NCHW latents."""
        if num_timesteps > self.num_timesteps:
            raise ValueError(
                f"num_timesteps={num_timesteps} exceeds the schedule length "
                f"T={self.num_timesteps}")
        content = content.to(self.device)
        z_0 = self.encoder(_nchw(content).to(self.dtype)).float()
        batch = z_0.shape[0]
        if noise is None:
            noise = per_item_noise(seeds, batch, tuple(_nhwc(z_0).shape[1:]),
                                   self.device)
        eps = _nchw(noise.to(device=self.device, dtype=torch.float32))
        t = torch.full((batch,), num_timesteps - 1, dtype=torch.long,
                       device=self.device)
        return self.schedule.q_sample_with_noise(z_0, t, eps)

    def decode_unit(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> NHWC f32 images in [0, 1]."""
        return (_nhwc(self.decoder(z.to(self.dtype))).float() + 1.0) / 2.0


def per_item_noise(seeds, batch: int, shape: Tuple[int, ...],
                   device) -> torch.Tensor:
    """[batch, *shape] standard normal noise, item i drawn from a
    generator seeded with seeds[i] (a scalar seed is shared)."""
    seeds = np.broadcast_to(np.asarray(seeds, np.int64), (batch,))
    out = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        out.append(torch.randn(shape, generator=g, device=device))
    return torch.stack(out)


def seeded_noise(shape: Tuple[int, ...], seed: int, device) -> torch.Tensor:
    """Standard normal noise of ``shape``, one generator seeded by
    ``seed``: the draw of generation from noise on both routes."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=g, device=device)


def _denoise_fn(ldm: LDM, emb: Dict[str, torch.Tensor],
                guidance: float = 1.0, f32: bool = True):
    """(x NCHW, t[B]) -> eps with the style pyramid (NCHW) bound.

    guidance != 1 applies classifier-free guidance
    eps = eps_u + g (eps_c - eps_u), both branches as ONE UNet call on a
    2B batch; the unconditional branch sees a zeroed pyramid.  Without
    guidance and with ``f32=False``, eps stays in the UNet's type (the
    DDIM update kernel reads bf16 itself); otherwise it is f32."""
    if guidance == 1.0:
        if not f32:
            return lambda x, t: ldm.unet(x, t, emb)
        return lambda x, t: ldm.unet(x, t, emb).float()
    emb2 = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in emb.items()}

    def fn(x, t):
        eps2 = ldm.unet(torch.cat([x, x]), torch.cat([t, t]), emb2).float()
        eps_c, eps_u = eps2.chunk(2)
        return eps_u + guidance * (eps_c - eps_u)
    return fn


def _run_sampler(sampler: str, ldm: LDM, emb: Dict[str, torch.Tensor],
                 guidance: float, z_t: torch.Tensor, times, eta,
                 return_logs: bool = False):
    """The scan sampler over ``times`` from NCHW ``z_t``; returns the final
    latent, or (latent, logs) with ``return_logs`` (NCHW logs)."""
    sched = ldm.schedule
    if sampler == "ddim":
        return ddim_sample(_denoise_fn(ldm, emb, guidance, f32=False), sched,
                           z_t, times, eta=eta, return_logs=return_logs)
    if sampler == "dpm++":
        if eta:
            raise ValueError("dpm++ is deterministic; eta must be 0")
        return dpm_solver_pp_2m(_denoise_fn(ldm, emb, guidance), sched, z_t,
                                times, return_logs=return_logs)
    raise ValueError(f"unknown sampler {sampler!r}")


def _nhwc_logs(logs: dict) -> dict:
    """Sampler logs [S-1, B, C, H, W] -> the JAX package's [S-1, B, H, W,
    C]."""
    return {"timesteps": logs["timesteps"],
            **{k: logs[k].permute(0, 1, 3, 4, 2)
               for k in ("pred_x0", "noise_pred")}}


@torch.no_grad()
def transfer_decoded(ldm: LDM, content: torch.Tensor, style: torch.Tensor,
                     num_timesteps: int = 100, eta: float = 0.0,
                     sampler: str = "ddim", steps: Optional[int] = None,
                     guidance: float = 1.0,
                     noise: Optional[torch.Tensor] = None,
                     seeds=0, return_logs: bool = False):
    """The scan-sampler transfer; returns (decoded NHWC [0, 1], z_t), and
    the sampler's NHWC logs third with ``return_logs``.  Traced as
    ``ldm.encode``, ``ldm.style``, ``ldm.sample`` and ``ldm.decode``
    (the last two on the device too)."""
    dev = ldm.device
    with span("ldm.encode"):
        z_t = ldm.noised_latents(content, num_timesteps, noise, seeds)
    with span("ldm.style"):
        emb = ldm.style_encoder(_nchw(style.to(dev)).to(ldm.dtype))
    times = transfer_time_grid(num_timesteps, steps)
    with span("ldm.sample", device=dev):
        sampled = _run_sampler(sampler, ldm, emb, guidance, z_t, times, eta,
                               return_logs)
    with span("ldm.decode", device=dev):
        decoded = ldm.decode_unit(sampled if not return_logs else sampled[0])
    if not return_logs:
        return decoded, z_t
    return decoded, z_t, _nhwc_logs(sampled[1])


def content_style_transfer(ldm: LDM, content: torch.Tensor,
                           style: torch.Tensor, num_timesteps: int = 100,
                           eta: float = 0.0, sampler: str = "ddim",
                           steps: Optional[int] = None,
                           guidance: float = 1.0,
                           noise: Optional[torch.Tensor] = None,
                           seeds=0, return_logs: bool = False):
    """SDEdit content+style transfer, the product path.

    content, style: NHWC [B, 128, 128, 1] in [0, 1].  num_timesteps must
    not exceed the schedule length.  ``noise`` [B, 16, 16, latent_dim]
    injects the partial-noising draw; otherwise per-item generators
    seeded by ``seeds`` draw it.  sampler 'dpm++' with steps < N walks a
    coarse DPM-Solver++(2M) grid; guidance != 1 applies classifier-free
    style guidance.  Returns (decoded, z_t_decoded), NHWC in [0, 1] and
    [-1, 1]; with ``return_logs`` also the sampler's per-step logs third,
    as the JAX package's: {"timesteps": [S-1], "pred_x0", "noise_pred":
    [S-1, B, 16, 16, latent_dim]}."""
    out = transfer_decoded(ldm, content, style, num_timesteps, eta,
                           sampler, steps, guidance, noise, seeds,
                           return_logs)
    with torch.no_grad():
        z_t_decoded = _nhwc(ldm.decoder(out[1].to(ldm.dtype))).float()
    return (out[0], z_t_decoded, *out[2:])


@torch.no_grad()
def style_ddim_sample(ldm: LDM, z_shape: Tuple[int, ...],
                      style: torch.Tensor, timesteps: int = 100,
                      eta: float = 0.0, sampler: str = "ddim",
                      guidance: float = 1.0, latent_stats=None,
                      noise: Optional[torch.Tensor] = None,
                      seed: int = 0, return_logs: bool = False):
    """Style-conditioned generation from noise over
    ``generation_time_grid(T, timesteps)``; returns decoded NHWC images in
    [0, 1], and with ``return_logs`` (images, NHWC logs) as
    ``content_style_transfer``'s.

    z_shape is NHWC [B, 16, 16, latent_dim].  ``noise`` (NHWC) is the
    draw as given; otherwise one generator seeded by ``seed`` draws it.
    latent_stats=(mu, sigma), each [latent_dim], moment-matches z_T to the
    schedule's marginal q(z_T) = N(sqrt(ab) mu, ab sigma^2 + 1 - ab) at
    t = T-1 (``corpus_latent_stats``) instead of N(0, I).  sampler
    'dpm++' runs DPM-Solver++(2M) on the same grid; guidance != 1 applies
    classifier-free style guidance."""
    dev = ldm.device
    if noise is None:
        noise = seeded_noise(z_shape, seed, dev)
    eps = noise.to(device=dev, dtype=torch.float32)
    if latent_stats is not None:
        mu, sigma = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                     for v in latent_stats)
        ab = ldm.schedule.alpha_bars[ldm.num_timesteps - 1]
        eps = torch.sqrt(ab) * mu + torch.sqrt(ab * sigma * sigma
                                               + (1.0 - ab)) * eps
    emb = ldm.style_encoder(_nchw(style.to(dev)).to(ldm.dtype))
    times = generation_time_grid(ldm.num_timesteps, timesteps)
    sampled = _run_sampler(sampler, ldm, emb, guidance, _nchw(eps), times,
                           eta, return_logs)
    if not return_logs:
        return ldm.decode_unit(sampled)
    return ldm.decode_unit(sampled[0]), _nhwc_logs(sampled[1])


@torch.no_grad()
def corpus_latent_stats(ldm: LDM, images, batch: int = 64
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mu, sigma) of the encoder's latents over [N, H, W, 1]
    images in [0, 1]: the inputs of moment-matched generation."""
    zs = []
    for s in range(0, len(images), batch):
        x = torch.as_tensor(np.asarray(images[s:s + batch], np.float32))
        zs.append(ldm.encode(x.to(ldm.device)).float().cpu().numpy())
    z = np.concatenate(zs).astype(np.float64)
    return (torch.as_tensor(z.mean(axis=(0, 1, 2)), dtype=torch.float32),
            torch.as_tensor(z.std(axis=(0, 1, 2)), dtype=torch.float32))


def match_moments(imgs: torch.Tensor, reference: torch.Tensor,
                  clip: Tuple[float, float] = (0.0, 1.0)) -> torch.Tensor:
    """Per-item affine level/contrast correction toward a reference:
    out = (img - mean) / std * std(ref) + mean(ref), clipped."""
    dims = tuple(range(1, imgs.ndim))
    m_o = imgs.mean(dim=dims, keepdim=True)
    s_o = imgs.std(dim=dims, keepdim=True, unbiased=False)
    m_r = reference.mean(dim=dims, keepdim=True)
    s_r = reference.std(dim=dims, keepdim=True, unbiased=False)
    out = (imgs - m_o) / torch.clamp(s_o, min=1e-6) * s_r + m_r
    return torch.clamp(out, clip[0], clip[1])


def _new_ldm(config: Config, seed: int) -> LDM:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LDM(latent_dim=config.model.latent_dim,
                    num_timesteps=config.diffusion.num_timesteps,
                    beta_start=config.diffusion.beta_start,
                    beta_end=config.diffusion.beta_end,
                    unet_num_filters=config.model.unet_num_filters,
                    style_num_filters=config.model.style_num_filters)
    model.requires_grad_(False)
    return model


def build_ldm(config: Optional[Config] = None, dtype=torch.float32,
              device="cuda", seed: int = 0) -> LDM:
    """A randomly initialised LDM (weights from ``seed``) in eval mode on
    ``device``; no checkpoint is involved."""
    device = resolve_device(device)
    model = _new_ldm(config or default_config(), seed)
    return model.to(device=device, dtype=dtype).eval()


def checkpoint_distill_meta(full_checkpoint) -> Optional[dict]:
    """The ``distill`` metadata a progressively distilled checkpoint
    carries ({"steps", "t_max", "stages", "guidance"}), or None for a
    stock checkpoint or an unreadable path (advisory callers only; load
    errors surface through ``load_ldm``)."""
    from music_style_transfer_ldm_tpu_torch.training import (
        checkpoint as ckpt_lib,   # imported here: training imports this
    )
    try:
        payload = ckpt_lib.load_checkpoint(full_checkpoint)
    except ckpt_lib.LOAD_ERRORS:
        return None
    meta = payload.get("distill")
    return dict(meta) if isinstance(meta, dict) else None


def load_ldm(config: Optional[Config] = None,
             full_checkpoint: Optional[str] = None,
             autoencoder_checkpoint: Optional[str] = None,
             use_ema: bool = True, dtype=torch.bfloat16,
             device="cuda") -> LDM:
    """An LDM in eval mode on ``device``, from checkpoints of the port.

    A full checkpoint that carries EMA weights gives those (the sampling
    convention) unless use_ema=False.  ``autoencoder_checkpoint`` (phase
    1's ``pretrained.pt``) gives the encoder and decoder, the rest keeping
    the seed-0 initialisation.  With both, the full checkpoint is tried
    first; if it cannot be read or does not fit, the failure is printed
    and the model falls back to the autoencoder's weights (the JAX
    package's fallback).  A full checkpoint that fails with no
    autoencoder checkpoint raises.  Without a checkpoint the weights are
    the seed-0 initialisation."""
    from music_style_transfer_ldm_tpu_torch.training import (
        checkpoint as ckpt_lib,   # imported here: training imports this
    )
    device = resolve_device(device)
    config = config or default_config()
    model = _new_ldm(config, seed=0)
    if full_checkpoint is not None:
        try:
            payload = ckpt_lib.load_checkpoint(full_checkpoint)
            model.load_state_dict(payload["params"])
            if use_ema and payload.get("ema_params") is not None:
                # EMA covers the parameters; BatchNorm statistics stay.
                _, unexpected = model.load_state_dict(
                    payload["ema_params"], strict=False)
                if unexpected:
                    raise ValueError(f"ema_params has unknown keys "
                                     f"{unexpected[:3]}")
                print("load_ldm: using EMA weights (pass use_ema=False for "
                      "raw)", flush=True)
        except ckpt_lib.LOAD_ERRORS as e:
            if autoencoder_checkpoint is None:
                raise
            print(f"Could not load full LDM checkpoint: {e}", flush=True)
            print("Falling back to encoder/decoder weights", flush=True)
            model = _new_ldm(config, seed=0)   # undo a partial load
        else:
            return model.to(device=device, dtype=dtype).eval()
    if autoencoder_checkpoint is not None:
        ae = ckpt_lib.load_autoencoder(autoencoder_checkpoint)["params"]
        model.encoder.load_state_dict(ae["encoder"])
        model.decoder.load_state_dict(ae["decoder"])
    return model.to(device=device, dtype=dtype).eval()
