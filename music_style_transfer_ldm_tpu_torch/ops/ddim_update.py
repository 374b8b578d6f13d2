"""One DDIM update step as a Triton kernel (kernel B).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/ddim_update.py``
``fused_ddim_update``: the five elementwise ops of the DDIM state update
in one pass over the latent,

    x0_hat = (x - sqrt(1-ab_t) eps) / sqrt(ab_t)
    x_new  = sqrt(ab_n) x0_hat
             + (sqrt(1-ab_n) + eta (sqrt(1-ab_n) - sqrt(1-ab_t))) eps

Bound on the H100: bytes. It reads x and eps once and writes x_new once,
3 x 4 B per element; at the serving shape [8, 16, 16, 32] that is
786,432 B, about 0.23 us at 3.35 TB/s, far below one launch's overhead.
The design is one masked 1-D pass, 1,024 elements a program.  The four
step scalars are folded on the host from the schedule's numpy copy and
passed as kernel arguments, so a sampler step costs no device sync.

On a CPU tensor the wrapper runs ``ddim_update_reference``; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_BLOCK = 1024


def step_scalars(ab_t: float, ab_next: float, eta: float):
    """(sqrt(1-ab_t), 1/sqrt(ab_t), sqrt(ab_n), dir coefficient) in f32,
    from host floats, so kernel and plain version share them exactly."""
    f = np.float32
    ab_t, ab_n, eta = f(ab_t), f(ab_next), f(eta)
    sq1m_t = np.sqrt(f(1.0) - ab_t)
    sq1m_n = np.sqrt(f(1.0) - ab_n)
    rs_t = f(1.0) / np.sqrt(ab_t)
    coeff = sq1m_n + eta * (sq1m_n - sq1m_t)
    return float(sq1m_t), float(rs_t), float(np.sqrt(ab_n)), float(coeff)


def ddim_update_reference(x: torch.Tensor, eps_hat: torch.Tensor,
                          ab_t: float, ab_next: float,
                          eta: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 arithmetic)."""
    sq1m_t, rs_t, sq_n, coeff = step_scalars(ab_t, ab_next, eta)
    x = x.float()
    eps = eps_hat.float()
    x0_hat = (x - sq1m_t * eps) * rs_t
    return sq_n * x0_hat + coeff * eps


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ddim_update_kernel(x_ptr, eps_ptr, out_ptr, n, sq1m_t, rs_t, sq_n,
                           coeff, BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        mask = offs < n
        x = tl.load(x_ptr + offs, mask=mask)
        eps = tl.load(eps_ptr + offs, mask=mask)
        x0_hat = (x - sq1m_t * eps) * rs_t
        tl.store(out_ptr + offs, sq_n * x0_hat + coeff * eps, mask=mask)

    return triton, ddim_update_kernel


def fused_ddim_update(x: torch.Tensor, eps_hat: torch.Tensor, ab_t: float,
                      ab_next: float, eta: float = 0.0) -> torch.Tensor:
    """One DDIM update over a latent batch of any shape; returns f32."""
    if x.shape != eps_hat.shape or x.device != eps_hat.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and eps_hat "
                         f"{tuple(eps_hat.shape)} on {eps_hat.device} differ")
    if x.device.type == "cpu":
        return ddim_update_reference(x, eps_hat, ab_t, ab_next, eta)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_ddim_update: no kernel for {x.device}")
    triton, kernel = _kernel()
    x = x.float().contiguous()
    eps = eps_hat.float().contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    # No mul+add -> fma contraction: each op rounds as the plain version's.
    kernel[(triton.cdiv(n, _BLOCK),)](x, eps, out, n,
                                      *step_scalars(ab_t, ab_next, eta),
                                      BLOCK=_BLOCK, num_warps=4,
                                      enable_fp_fusion=False)
    fused_ddim_update.launches += 1
    return out


fused_ddim_update.launches = 0
