"""DDIM sampling: a Python loop over the timestep grid.

Each step is one denoiser call and one update through
``ops.ddim_update.fused_ddim_update`` (the Triton kernel on CUDA
tensors, its plain version on CPU tensors).  The step scalars come from
the schedule's host copy, so the loop never waits on the device.

Update rule (eta interpolates the direction terms and adds no fresh
noise, as in the JAX package):

  x0_hat = (x - sqrt(1-ab_t) eps_hat) / sqrt(ab_t)
  x <- sqrt(ab_next) x0_hat + sqrt(1-ab_next) eps_hat
       + eta (sqrt(1-ab_next) - sqrt(1-ab_t)) eps_hat
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
)
from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
    fused_ddim_update,
)


def generation_time_grid(num_timesteps: int, steps: int) -> np.ndarray:
    """times = linspace(T-1, 0, steps) floored to int."""
    return np.linspace(num_timesteps - 1, 0, steps).astype(np.int32)


def transfer_time_grid(num_timesteps: int,
                       steps: int | None = None) -> np.ndarray:
    """Unit-step grid over the first N timesteps; steps < N subsamples it.

    steps > N is rejected: flooring more linspace points than integers in
    the range guarantees duplicate consecutive timesteps, which divide by
    a zero log-SNR step in DPM-Solver++."""
    if steps is not None and steps > num_timesteps:
        raise ValueError(f"steps={steps} > num_timesteps={num_timesteps}: "
                         "the grid would contain duplicate timesteps")
    return np.linspace(num_timesteps - 1, 0,
                       steps or num_timesteps).astype(np.int32)


def ddim_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
                schedule: DiffusionSchedule, x: torch.Tensor,
                times: np.ndarray, eta: float = 0.0) -> torch.Tensor:
    """Run DDIM over a descending grid ``times`` [S]: S-1 update steps.

    denoise_fn: (x, t[B]) -> predicted noise, f32.
    """
    times = np.asarray(times, np.int32)
    ab = schedule.alpha_bars_np
    batch = x.shape[0]
    x = x.float()
    for t, t_next in zip(times[:-1], times[1:]):
        t_b = torch.full((batch,), int(t), dtype=torch.int32, device=x.device)
        eps_hat = denoise_fn(x, t_b)
        x = fused_ddim_update(x, eps_hat, float(ab[t]), float(ab[t_next]),
                              eta)
    return x
