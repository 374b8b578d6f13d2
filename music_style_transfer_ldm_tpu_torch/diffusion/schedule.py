"""DDPM forward process: linear or ``scaled_linear`` beta schedule,
closed-form q-sampling.

The tables live twice: as float32 numpy arrays on the host, so the
samplers read per-step scalars with no device sync, and as tensors on
the model's device for the batched gathers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int = 200, beta_start: float = 1e-4,
                         beta_end: float = 0.02) -> np.ndarray:
    """Linear beta in [beta_start, beta_end], float32."""
    return np.linspace(beta_start, beta_end, num_timesteps,
                       dtype=np.float64).astype(np.float32)


def scaled_linear_beta_schedule(num_timesteps: int = 1000,
                                beta_start: float = 0.00085,
                                beta_end: float = 0.012) -> np.ndarray:
    """Stable Diffusion's ``scaled_linear``: betas whose square roots
    are linear from sqrt(beta_start) to sqrt(beta_end), float32."""
    return (np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                        dtype=np.float64) ** 2).astype(np.float32)


BETA_SCHEDULES = {"linear": linear_beta_schedule,
                  "scaled_linear": scaled_linear_beta_schedule}


class DiffusionSchedule:
    """Precomputed schedule tables ``betas``, ``alphas`` = 1 - betas and
    their cumulative product ``alpha_bars`` (host numpy + device
    tensors)."""

    def __init__(self, num_timesteps: int = 200, beta_start: float = 1e-4,
                 beta_end: float = 0.02, device="cpu",
                 kind: str = "linear"):
        self.betas_np = BETA_SCHEDULES[kind](num_timesteps, beta_start,
                                             beta_end)
        self.alphas_np = np.float32(1.0) - self.betas_np
        self.alpha_bars_np = np.cumprod(self.alphas_np, dtype=np.float32)
        self.betas, self.alphas, self.alpha_bars = (
            torch.as_tensor(a, device=device) for a in (
                self.betas_np, self.alphas_np, self.alpha_bars_np))

    @classmethod
    def create(cls, num_timesteps: int = 200, beta_start: float = 1e-4,
               beta_end: float = 0.02, device="cpu") -> "DiffusionSchedule":
        """The JAX package's constructor."""
        return cls(num_timesteps, beta_start, beta_end, device)

    @property
    def num_timesteps(self) -> int:
        return len(self.alpha_bars_np)

    def _gather(self, t: torch.Tensor, x_ndim: int) -> torch.Tensor:
        ab = self.alpha_bars.to(t.device)[t.long()]
        return ab.reshape(ab.shape + (1,) * (x_ndim - ab.ndim))

    def q_sample(self, generator: Optional[torch.Generator],
                 x0: torch.Tensor, t: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward process: (z_t, eps) with eps ~ N(0, 1) drawn from
        ``generator`` (on x0's device; None draws from the global
        generator), z_t = ``q_sample_with_noise(x0, t, eps)``."""
        eps = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                          device=x0.device)
        return self.q_sample_with_noise(x0, t, eps), eps

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
