"""DPM-Solver++(2M): second-order multistep ODE sampler.

Same contract as ``ddim_sample``: S-1 update steps over ``times`` [S].
The first step is first-order (no history); later steps use the 2M
correction  D_i = (1 + 1/(2 r_i)) x0_i - x0_{i-1}/(2 r_i)  with
r_i = h_{i-1}/h_i and the exponential update
x_{i+1} = (sigma_n/sigma_t) x - alpha_n (e^{-h} - 1) D_i.
The per-step scalars are computed on the host in float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.diffusion.ddim import sampler_logs
from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
)


def dpm_solver_pp_2m(denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor],
                     schedule: DiffusionSchedule, x: torch.Tensor,
                     times: np.ndarray, return_logs: bool = False):
    """Returns the final f32 latent; with ``return_logs``, (latent, logs)
    with ``ddim.sampler_logs``'s keys (pred_x0 is each step's x0)."""
    times = np.asarray(times, np.int32)
    if times.ndim == 1 and len(np.unique(times)) != len(times):
        raise ValueError(
            "duplicate timesteps in the grid: the multistep update divides "
            "by the log-SNR step h, which is zero across a duplicate pair "
            "(use steps <= num_timesteps)")
    f = np.float32
    ab = schedule.alpha_bars_np
    batch = x.shape[0]
    x = x.float()
    logs = sampler_logs(times, x) if return_logs else None
    prev_x0 = None
    prev_lam = f(0.0)
    for i, (t, t_next) in enumerate(zip(times[:-1], times[1:])):
        a_t, s_t = np.sqrt(ab[t]), np.sqrt(f(1.0) - ab[t])
        a_n, s_n = np.sqrt(ab[t_next]), np.sqrt(f(1.0) - ab[t_next])
        lam_t, lam_n = np.log(a_t / s_t), np.log(a_n / s_n)
        t_b = torch.full((batch,), int(t), dtype=torch.int32, device=x.device)
        eps_hat = denoise_fn(x, t_b)
        x0 = (x - float(s_t) * eps_hat) / float(a_t)
        if logs is not None:
            logs["pred_x0"][i].copy_(x0)
            logs["noise_pred"][i].copy_(eps_hat)
        h = lam_n - lam_t
        if prev_x0 is None:
            D = x0
        else:
            r = (lam_t - prev_lam) / h
            D = x0 + (x0 - prev_x0) / float(f(2.0) * r)
        x = float(s_n / s_t) * x - float(a_n * np.expm1(-h)) * D
        prev_x0, prev_lam = x0, lam_t
    return x if logs is None else (x, logs)
