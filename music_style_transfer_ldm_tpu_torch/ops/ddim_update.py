"""One DDIM update step as a CUDA kernel (kernel B).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/ddim_update.py``
``fused_ddim_update``: the five elementwise ops of the DDIM state update
in one pass over the latent,

    x0_hat = (x - sqrt(1-ab_t) eps) / sqrt(ab_t)
    x_new  = sqrt(ab_n) x0_hat
             + (sqrt(1-ab_n) + eta (sqrt(1-ab_n) - sqrt(1-ab_t))) eps

Two entries, both counted in ``fused_ddim_update.launches``:

- ``fused_ddim_update(x, eps_hat, ab_t, ab_next, eta)`` returns a new
  f32 tensor;
- ``ddim_update_(x, eps_hat, scalars, x0_out=None)`` updates an f32
  ``x`` in place, with ``scalars = step_scalars(ab_t, ab_next, eta)``
  folded once per trajectory by the sampler, and writes x0_hat to
  ``x0_out`` when given (the sampler's ``pred_x0`` log).

eps_hat may be f32 or bf16 (the UNet's own type); x0_hat and x_new are
f32.  On a CUDA tensor each entry launches ``csrc/ddim_update.cu`` (built
with nvcc at first use, bound with ctypes; the source explains the
design and the bound); on a CPU tensor it runs the plain version
(``ddim_update_reference``); on any other device it raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.ops._build import build_library
from music_style_transfer_ldm_tpu_torch.ops._launch import stream_handle

# No mul+add -> fma contraction: each op rounds as the plain version's.
_FLAGS = ("--fmad=false",)
_EPS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

Scalars = Tuple[float, float, float, float]


def step_scalars(ab_t: float, ab_next: float, eta: float) -> Scalars:
    """(sqrt(1-ab_t), 1/sqrt(ab_t), sqrt(ab_n), dir coefficient) in f32,
    from host floats, so kernel and plain version share them exactly."""
    f = np.float32
    ab_t, ab_n, eta = f(ab_t), f(ab_next), f(eta)
    sq1m_t = np.sqrt(f(1.0) - ab_t)
    sq1m_n = np.sqrt(f(1.0) - ab_n)
    rs_t = f(1.0) / np.sqrt(ab_t)
    coeff = sq1m_n + eta * (sq1m_n - sq1m_t)
    return float(sq1m_t), float(rs_t), float(np.sqrt(ab_n)), float(coeff)


def ddim_step_reference(x: torch.Tensor, eps_hat: torch.Tensor,
                        scalars: Scalars
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``ddim_update_``: (x_new, x0_hat) in f32, each op
    as the kernel rounds it."""
    sq1m_t, rs_t, sq_n, coeff = scalars
    eps = eps_hat.float()
    x0_hat = (x.float() - sq1m_t * eps) * rs_t
    return sq_n * x0_hat + coeff * eps, x0_hat


def ddim_update_reference(x: torch.Tensor, eps_hat: torch.Tensor,
                          ab_t: float, ab_next: float,
                          eta: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 arithmetic)."""
    scalars = step_scalars(ab_t, ab_next, eta)
    return ddim_step_reference(x, eps_hat, scalars)[0]


def build_ddim_update() -> dict:
    """Compile csrc/ddim_update.cu (ops/_build.py)."""
    return build_library("ddim_update.cu", _FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(build_ddim_update()["path"])
    lib.ddim_update.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_longlong] + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    lib.ddim_update.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, eps: torch.Tensor, out: torch.Tensor,
            x0_out: Optional[torch.Tensor], scalars: Scalars) -> None:
    err = _library().ddim_update(
        x.data_ptr(), eps.data_ptr(), _EPS_DTYPES[eps.dtype], out.data_ptr(),
        None if x0_out is None else x0_out.data_ptr(), x.numel(), *scalars,
        stream_handle(x.device))
    if err != 0:
        raise RuntimeError(f"DDIM update kernel launch failed: CUDA error "
                           f"{err}")
    fused_ddim_update.launches += 1


def _check_pair(x: torch.Tensor, eps_hat: torch.Tensor, name: str) -> None:
    if x.shape != eps_hat.shape or x.device != eps_hat.device:
        raise ValueError(f"{name}: x {tuple(x.shape)} on {x.device} and "
                         f"eps_hat {tuple(eps_hat.shape)} on "
                         f"{eps_hat.device} differ")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for {x.device}")


def _kernel_eps(eps_hat: torch.Tensor) -> torch.Tensor:
    """eps in a type the kernel reads (f32 or bf16), contiguous."""
    if eps_hat.dtype not in _EPS_DTYPES:
        eps_hat = eps_hat.float()
    return eps_hat.contiguous()


def fused_ddim_update(x: torch.Tensor, eps_hat: torch.Tensor, ab_t: float,
                      ab_next: float, eta: float = 0.0) -> torch.Tensor:
    """One DDIM update over a latent batch of any shape; returns a new f32
    tensor."""
    _check_pair(x, eps_hat, "fused_ddim_update")
    if x.device.type == "cpu":
        return ddim_update_reference(x, eps_hat, ab_t, ab_next, eta)
    x = x.float().contiguous()
    out = torch.empty_like(x)
    _launch(x, _kernel_eps(eps_hat), out, None,
            step_scalars(ab_t, ab_next, eta))
    return out


def ddim_update_(x: torch.Tensor, eps_hat: torch.Tensor, scalars: Scalars,
                 x0_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The update in place: x (f32, contiguous) <- x_new, and x0_hat into
    ``x0_out`` (f32, x's shape, contiguous) when given; ``scalars`` from
    ``step_scalars``.  Returns x."""
    _check_pair(x, eps_hat, "ddim_update_")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"ddim_update_: x must be contiguous float32, got "
                         f"{x.dtype}")
    if x0_out is not None and (
            x0_out.dtype != torch.float32 or x0_out.shape != x.shape
            or x0_out.device != x.device or not x0_out.is_contiguous()):
        raise ValueError(f"ddim_update_: x0_out must be contiguous float32 "
                         f"{tuple(x.shape)} on {x.device}")
    if x.device.type == "cpu":
        new, x0_hat = ddim_step_reference(x, eps_hat, scalars)
        x.copy_(new)
        if x0_out is not None:
            x0_out.copy_(x0_hat)
        return x
    _launch(x, _kernel_eps(eps_hat), x, x0_out, scalars)
    return x


fused_ddim_update.launches = 0
