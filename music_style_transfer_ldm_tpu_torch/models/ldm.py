"""The composite latent diffusion model and its transfer wrappers.

``LDM`` holds the encoder, decoder, UNet and style encoder (NCHW inside).
Its public methods take and return the JAX package's NHWC layout, so a
test compares like with like.  ``content_style_transfer`` is the SDEdit
product path: encode content, noise it to t = N-1 with per-item noise,
walk the grid with DDIM or DPM-Solver++(2M) conditioned on the style
pyramid, decode.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.config import Config, default_config
from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    ddim_sample, transfer_time_grid,
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
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device


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

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 128, 128, 1] -> [B, 16, 16, latent_dim], model dtype."""
        return _nhwc(self.encoder(_nchw(x).to(self.dtype)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, 16, 16, latent_dim] -> [B, 128, 128, 1] in [-1, 1]."""
        return _nhwc(self.decoder(_nchw(z).to(self.dtype)))

    def style_embed(self, style: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[B, 128, 128, 1] -> {s1..s6} NHWC maps."""
        emb = self.style_encoder(_nchw(style).to(self.dtype))
        return {k: _nhwc(v) for k, v in emb.items()}

    def denoise(self, z_t: torch.Tensor, t: torch.Tensor,
                style_embedding: Dict[str, torch.Tensor]) -> torch.Tensor:
        """UNet on NHWC latents with an NHWC style pyramid."""
        emb = {k: _nchw(v) for k, v in style_embedding.items()}
        return _nhwc(self.unet(_nchw(z_t), t, emb))

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


def _denoise_fn(ldm: LDM, emb: Dict[str, torch.Tensor],
                guidance: float = 1.0):
    """(x NCHW, t[B]) -> eps f32 with the style pyramid (NCHW) bound.

    guidance != 1 applies classifier-free guidance
    eps = eps_u + g (eps_c - eps_u), both branches as ONE UNet call on a
    2B batch; the unconditional branch sees a zeroed pyramid."""
    if guidance == 1.0:
        return lambda x, t: ldm.unet(x, t, emb).float()
    emb2 = {k: torch.cat([v, torch.zeros_like(v)]) for k, v in emb.items()}

    def fn(x, t):
        eps2 = ldm.unet(torch.cat([x, x]), torch.cat([t, t]), emb2).float()
        eps_c, eps_u = eps2.chunk(2)
        return eps_u + guidance * (eps_c - eps_u)
    return fn


def _run_sampler(sampler: str, denoise_fn, sched, z_t, times, eta):
    if sampler == "ddim":
        return ddim_sample(denoise_fn, sched, z_t, times, eta=eta)
    if sampler == "dpm++":
        if eta:
            raise ValueError("dpm++ is deterministic; eta must be 0")
        return dpm_solver_pp_2m(denoise_fn, sched, z_t, times)
    raise ValueError(f"unknown sampler {sampler!r}")


@torch.no_grad()
def transfer_decoded(ldm: LDM, content: torch.Tensor, style: torch.Tensor,
                     num_timesteps: int = 100, eta: float = 0.0,
                     sampler: str = "ddim", steps: Optional[int] = None,
                     guidance: float = 1.0,
                     noise: Optional[torch.Tensor] = None,
                     seeds=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan-sampler transfer; returns (decoded NHWC [0, 1], z_t)."""
    z_t = ldm.noised_latents(content, num_timesteps, noise, seeds)
    emb = ldm.style_encoder(_nchw(style.to(ldm.device)).to(ldm.dtype))
    times = transfer_time_grid(num_timesteps, steps)
    sampled = _run_sampler(sampler, _denoise_fn(ldm, emb, guidance),
                           ldm.schedule, z_t, times, eta)
    return ldm.decode_unit(sampled), z_t


def content_style_transfer(ldm: LDM, content: torch.Tensor,
                           style: torch.Tensor, num_timesteps: int = 100,
                           eta: float = 0.0, sampler: str = "ddim",
                           steps: Optional[int] = None,
                           guidance: float = 1.0,
                           noise: Optional[torch.Tensor] = None,
                           seeds=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDEdit content+style transfer, the product path.

    content, style: NHWC [B, 128, 128, 1] in [0, 1].  num_timesteps must
    not exceed the schedule length.  ``noise`` [B, 16, 16, latent_dim]
    injects the partial-noising draw; otherwise per-item generators
    seeded by ``seeds`` draw it.  sampler 'dpm++' with steps < N walks a
    coarse DPM-Solver++(2M) grid; guidance != 1 applies classifier-free
    style guidance.  Returns (decoded, z_t_decoded), NHWC in [0, 1] and
    [-1, 1]."""
    decoded, z_t = transfer_decoded(ldm, content, style, num_timesteps, eta,
                                    sampler, steps, guidance, noise, seeds)
    with torch.no_grad():
        z_t_decoded = _nhwc(ldm.decoder(z_t.to(ldm.dtype))).float()
    return decoded, z_t_decoded


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


def build_ldm(config: Optional[Config] = None, dtype=torch.float32,
              device="cuda", seed: int = 0) -> LDM:
    """A randomly initialised LDM (weights from ``seed``) in eval mode on
    ``device``; no checkpoint is involved."""
    device = resolve_device(device)
    config = config or default_config()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LDM(latent_dim=config.model.latent_dim,
                    num_timesteps=config.diffusion.num_timesteps,
                    beta_start=config.diffusion.beta_start,
                    beta_end=config.diffusion.beta_end,
                    unet_num_filters=config.model.unet_num_filters,
                    style_num_filters=config.model.style_num_filters)
    model.requires_grad_(False)
    return model.to(device=device, dtype=dtype).eval()
