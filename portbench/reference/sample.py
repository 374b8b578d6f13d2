"""The plain reference of a served transfer: SDEdit content-style
transfer with DDIM (eta 0) on the unit-step grid over the first N
timesteps of a linear schedule.

Encode the content, noise it to t = N - 1 with the request's own draw
(a generator seeded by the request's seed, one [16, 16, latent] normal
draw in NHWC order), then for each step t -> t_next

    x0 = (x - sqrt(1 - ab_t) eps) / sqrt(ab_t)
    x  = sqrt(ab_next) x0 + sqrt(1 - ab_next) eps

with eps the UNet's prediction conditioned on the style pyramid, and
decode to a unit image.  Both of the program's routes (the fused
trajectory kernel and the scan sampler) compute this.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from portbench.reference import nets


def alpha_bars(model: dict) -> np.ndarray:
    betas = np.linspace(model["beta_start"], model["beta_end"],
                        model["num_timesteps"],
                        dtype=np.float64).astype(np.float32)
    return np.cumprod(np.float32(1.0) - betas, dtype=np.float32)


def request_noise(seeds: Sequence[int], latent: int, size: int,
                  device) -> torch.Tensor:
    """[B, latent, size, size]: request i's draw from a generator seeded
    with seeds[i], drawn NHWC."""
    out = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        out.append(torch.randn((size, size, latent), generator=g,
                               device=device))
    return torch.stack(out).permute(0, 3, 1, 2)


def transfer(P: dict, content: torch.Tensor, style: torch.Tensor,
             seeds: Sequence[int], model: dict, steps: int,
             prec: nets.Precision = nets.F32) -> torch.Tensor:
    """content, style [B, 128, 128] unit images -> decoded [B, 128, 128]
    unit images."""
    ab = alpha_bars(model)
    with torch.no_grad():
        z0 = nets.encoder(P, content[:, None].float(), prec)
        eps = request_noise(seeds, z0.shape[1], z0.shape[-1], z0.device)
        t0 = steps - 1
        x = (torch.sqrt(torch.tensor(ab[t0], device=z0.device)) * z0
             + torch.sqrt(torch.tensor(1.0 - ab[t0], device=z0.device))
             * eps)
        s5, s6 = nets.style_pyramid(P, style[:, None].float(), prec)
        times = np.linspace(steps - 1, 0, steps).astype(np.int32)
        for t, tn in zip(times[:-1], times[1:]):
            tt = torch.full((x.shape[0],), int(t), device=x.device)
            e = nets.unet(P, x, tt, s5, s6, model["attn_num_heads"], prec)
            f = np.float32
            x0 = (x - float(np.sqrt(f(1.0) - ab[t])) * e) * float(
                f(1.0) / np.sqrt(ab[t]))
            x = float(np.sqrt(ab[tn])) * x0 + float(
                np.sqrt(f(1.0) - ab[tn])) * e
        return (nets.decoder(P, x, prec=prec)[:, 0] + 1.0) / 2.0
