"""DDPM forward process: linear beta schedule, closed-form q-sampling.

The tables live twice: as float32 numpy arrays on the host, so the
samplers read per-step scalars with no device sync, and as tensors on
the model's device for the batched gathers.
"""

from __future__ import annotations

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int = 200, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """Linear beta in [beta_start, beta_end], float32."""
    return np.linspace(beta_start, beta_end, num_timesteps,
                       dtype=np.float64).astype(np.float32)


class DiffusionSchedule:
    """Precomputed schedule tables (host numpy + device tensors)."""

    def __init__(self, num_timesteps: int = 200, beta_start: float = 1e-4,
                 beta_end: float = 0.02, device="cpu"):
        betas = linear_beta_schedule(num_timesteps, beta_start, beta_end)
        self.alpha_bars_np = np.cumprod(np.float32(1.0) - betas,
                                        dtype=np.float32)
        self.alpha_bars = torch.as_tensor(self.alpha_bars_np, device=device)

    @property
    def num_timesteps(self) -> int:
        return len(self.alpha_bars_np)

    def _gather(self, t: torch.Tensor, x_ndim: int) -> torch.Tensor:
        ab = self.alpha_bars.to(t.device)[t.long()]
        return ab.reshape(ab.shape + (1,) * (x_ndim - ab.ndim))

    def q_sample_with_noise(self, x0: torch.Tensor, t: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
        """sqrt(ab_t) x0 + sqrt(1 - ab_t) eps."""
        ab = self._gather(t, x0.ndim)
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps

    def predict_start_from_noise(self, z_t: torch.Tensor, t: torch.Tensor,
                                 noise_pred: torch.Tensor) -> torch.Tensor:
        """x0_hat = (z_t - sqrt(1 - ab_t) eps_hat) / sqrt(ab_t)."""
        ab = self._gather(t, z_t.ndim)
        return (z_t - torch.sqrt(1.0 - ab) * noise_pred) / torch.sqrt(ab)
