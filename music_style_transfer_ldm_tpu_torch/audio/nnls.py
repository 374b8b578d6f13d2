"""Batched non-negative least squares for mel inversion.

Solves  min_{X>=0} ||B X - M||_F^2  by accelerated projected gradient
(FISTA), batched over (batch, time), with a pseudo-inverse warm start and
step 1/L, L = sigma_max(B)^2.  L and the pseudo-inverse come from numpy,
once per filterbank.  The two products per iteration lie outside any
kernel of the TPU package and go to torch.matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _statics(key: bytes, shape) -> tuple:
    B = np.frombuffer(key, np.float32).reshape(shape)
    L = float(np.linalg.norm(B, 2) ** 2)
    return L, np.linalg.pinv(B).astype(np.float32)


def nnls(B: np.ndarray, M: torch.Tensor, n_iter: int = 64) -> torch.Tensor:
    """B: [n_mels, n_freq] filterbank (numpy); M: [..., n_mels, T] mel
    power.  Returns X: [..., n_freq, T] f32 on M's device."""
    B_np = np.ascontiguousarray(B, np.float32)
    L, pinv = _statics(B_np.tobytes(), B_np.shape)
    dev = M.device
    Bt = torch.as_tensor(B_np, device=dev)
    M = M.float()
    x = torch.clamp(torch.matmul(torch.as_tensor(pinv, device=dev), M),
                    min=0.0)
    y = x
    inv_L = np.float32(1.0 / L)
    t = np.float32(1.0)
    for _ in range(n_iter):
        grad = torch.matmul(Bt.T, torch.matmul(Bt, y) - M)
        x_new = torch.clamp(y - float(inv_L) * grad, min=0.0)
        t_new = np.float32(0.5) * (np.float32(1.0)
                                   + np.sqrt(np.float32(1.0)
                                             + np.float32(4.0) * t * t))
        y = x_new + float((t - np.float32(1.0)) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x
