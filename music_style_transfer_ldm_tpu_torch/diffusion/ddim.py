"""DDIM sampling: a Python loop over the timestep grid.

Each step is one denoiser call and one in-place update of the latent
through ``ops.ddim_update.ddim_update_`` (kernel B on CUDA tensors, its
plain version on CPU tensors).  The loop copies the start latent once,
folds every step's scalars on the host and puts the [S-1, B] timestep
table on the device once per trajectory, so a step costs the denoiser
and one kernel launch and never waits on the device.

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
    ddim_update_, step_scalars,
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


def sampler_logs(times: np.ndarray, x: torch.Tensor) -> dict:
    """Empty per-step logs of a trajectory from ``x`` over ``times`` [S],
    keyed as the JAX package's: timesteps [S-1] int32, pred_x0 and
    noise_pred [S-1, *x.shape] f32."""
    n = len(times) - 1
    return {"timesteps": torch.from_numpy(
                np.ascontiguousarray(times[:-1], np.int32)).to(x.device),
            "pred_x0": x.new_empty((n, *x.shape), dtype=torch.float32),
            "noise_pred": x.new_empty((n, *x.shape), dtype=torch.float32)}


def ddim_sample(denoise_fn: Callable[[torch.Tensor, torch.Tensor],
                                     torch.Tensor],
                schedule: DiffusionSchedule, x: torch.Tensor,
                times: np.ndarray, eta: float = 0.0,
                return_logs: bool = False):
    """Run DDIM over a descending grid ``times`` [S]: S-1 update steps.

    denoise_fn: (x, t[B]) -> predicted noise, f32 or bf16.  ``x`` itself
    is not modified.  Returns the final f32 latent; with ``return_logs``,
    (latent, logs) with ``sampler_logs``'s keys, pred_x0 written by the
    update itself.
    """
    times = np.asarray(times, np.int32)
    ab = schedule.alpha_bars_np
    batch = x.shape[0]
    # One copy on entry: the update runs in place, and callers keep the
    # start latent (the transfer decodes z_t after sampling).
    x = x.to(dtype=torch.float32, memory_format=torch.contiguous_format,
             copy=True)
    scalars = [step_scalars(float(ab[t]), float(ab[t_next]), eta)
               for t, t_next in zip(times[:-1], times[1:])]
    t_table = torch.from_numpy(np.repeat(times[:-1, None], batch, 1)).to(
        x.device, non_blocking=True)
    logs = sampler_logs(times, x) if return_logs else None
    for i, sc in enumerate(scalars):
        eps_hat = denoise_fn(x, t_table[i])
        ddim_update_(x, eps_hat, sc,
                     None if logs is None else logs["pred_x0"][i])
        if logs is not None:
            logs["noise_pred"][i].copy_(eps_hat)
    return x if logs is None else (x, logs)
