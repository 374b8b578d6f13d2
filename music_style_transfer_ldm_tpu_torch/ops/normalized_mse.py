"""One std-normalized feature-MSE layer as CUDA kernels (kernel D).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/normalized_mse.py``
``normalized_mse_pallas``.  Per sample of feature maps p, t (any layout;
statistics over all of a sample's elements, in f32, eps = 1e-8):
m = mean((p / (s_p + eps) - t / (s_t + eps))^2), and the loss is the
weights-renormalised mean of m.  The backward is the closed form of
``losses/vggish.py``'s ``normalized_mse``, dp and dt as two launches of
one kernel, each only when autograd asks for it.

``normalized_mse_forward`` and ``normalized_mse_backward`` launch
``csrc/normalized_mse.cu`` (built with nvcc at first use, bound with
ctypes; the source explains the design and the bound) on CUDA tensors,
run their plain PyTorch versions ``*_reference`` on CPU tensors, and
raise on any other device.  The backward's extra options (add an f32
gradient, mask by p > 0, write f32) serve the VGGish trunk kernel
(``ops/fused_trunk.py``), which takes its per-layer metrics and direct
metric gradients from here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from music_style_transfer_ldm_tpu_torch.ops._build import build_library

EPS = 1e-8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The plain version's statistics dtype (float64 gives tests an oracle).
STAT_DTYPE = torch.float32


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _stat(x: torch.Tensor) -> torch.Tensor:
    return _flat(x).to(STAT_DTYPE)


def normalized_mse_forward_reference(p: torch.Tensor, t: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: p, t [B, ...] -> (m [B], stats [B, 4] = mu_p, s_p,
    mu_t, s_t), all f32, two-pass statistics."""
    p32, t32 = _stat(p), _stat(t)
    mu_p = p32.mean(1)
    s_p = ((p32 - mu_p[:, None]) ** 2).mean(1).sqrt()
    mu_t = t32.mean(1)
    s_t = ((t32 - mu_t[:, None]) ** 2).mean(1).sqrt()
    d = p32 / (s_p + EPS)[:, None] - t32 / (s_t + EPS)[:, None]
    return ((d * d).mean(1).float(),
            torch.stack([mu_p, s_p, mu_t, s_t], 1).float())


def normalized_mse_backward_reference(
        p: torch.Tensor, t: torch.Tensor, stats: torch.Tensor,
        uscale: torch.Tensor, wrt_target: bool,
        gin: Optional[torch.Tensor] = None, mask: bool = False,
        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the closed-form gradient with per-sample upstream
    ``uscale`` [B]: dp (or dt with wrt_target), plus ``gin`` (f32, p's
    shape) when given, zeroed where p <= 0 when ``mask``; in
    ``out_dtype`` (default: the differentiated input's)."""
    p32, t32 = _stat(p), _stat(t)
    n = float(p32.shape[1])
    mu_p, s_p, mu_t, s_t = (stats[:, i:i + 1].to(p32.dtype) for i in range(4))
    u = (2.0 / n) * uscale.to(p32.dtype)[:, None] * (
        p32 / (s_p + EPS) - t32 / (s_t + EPS))
    if wrt_target:
        b = (u * t32).sum(1, keepdim=True)
        out = -u / (s_t + EPS) + b * (t32 - mu_t) / (
            (s_t + EPS) ** 2 * n * s_t)
    else:
        a = (u * p32).sum(1, keepdim=True)
        out = u / (s_p + EPS) - a * (p32 - mu_p) / (
            (s_p + EPS) ** 2 * n * s_p)
    if gin is not None:
        out = _stat(gin) + out
    if mask:
        out = torch.where(p32 > 0, out, torch.zeros_like(out))
    ref = t if wrt_target else p
    return out.reshape(ref.shape).to(out_dtype or ref.dtype)


def build_normalized_mse() -> dict:
    """Compile csrc/normalized_mse.cu (ops/_build.py)."""
    return build_library("normalized_mse.cu")


@functools.cache
def _library():
    lib = ctypes.CDLL(build_normalized_mse()["path"])
    lib.nm_chunks.argtypes = [ctypes.c_longlong]
    lib.nm_chunks.restype = ctypes.c_int
    lib.nm_forward.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 4)
    lib.nm_forward.restype = ctypes.c_int
    lib.nm_backward.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p])
    lib.nm_backward.restype = ctypes.c_int
    return lib


def _operand(x: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    """Contiguous, of ``dtype``, with 16-byte aligned rows."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"expected {dtype} {tuple(shape)}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(p: torch.Tensor, t: torch.Tensor, name: str) -> int:
    """Validate p, t and return N (elements per sample); raise off the
    CPU and the card."""
    if p.shape != t.shape or p.dtype != t.dtype or p.device != t.device:
        raise ValueError(f"{name}: p {p.dtype} {tuple(p.shape)} on "
                         f"{p.device} and t {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} must match")
    if p.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name}: no kernel for {p.device}")
    n = p[0].numel() if p.shape[0] else 0
    if p.device.type == "cuda":
        if p.dtype not in _DTYPES:
            raise ValueError(f"{name}: kernel D takes float32 or bfloat16, "
                             f"got {p.dtype}")
        if n % 8:
            raise ValueError(f"{name}: kernel D needs a multiple of 8 "
                             f"elements per sample, got {n}")
    return n


def normalized_mse_forward(p: torch.Tensor, t: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """p, t [B, ...] (f32 or bf16) -> (m [B], stats [B, 4]) f32.  CUDA
    tensors launch kernel D's forward; CPU tensors run the plain
    version."""
    n = _check(p, t, "normalized_mse_forward")
    if p.device.type == "cpu":
        return normalized_mse_forward_reference(p, t)
    lib = _library()
    B = p.shape[0]
    p, t = _operand(p, p.dtype, p.shape), _operand(t, p.dtype, p.shape)
    dev = p.device
    m = torch.empty(B, dtype=torch.float32, device=dev)
    stats = torch.empty(B, 4, dtype=torch.float32, device=dev)
    work = torch.empty(5 * B * lib.nm_chunks(n), dtype=torch.float32,
                       device=dev)
    err = lib.nm_forward(p.data_ptr(), t.data_ptr(), _DTYPES[p.dtype], B, n,
                         m.data_ptr(), stats.data_ptr(), work.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalized-MSE forward kernel launch failed: "
                           f"CUDA error {err}")
    normalized_mse_forward.launches += 1
    return m, stats


normalized_mse_forward.launches = 0


def normalized_mse_backward(p: torch.Tensor, t: torch.Tensor,
                            stats: torch.Tensor, uscale: torch.Tensor,
                            wrt_target: bool,
                            gin: Optional[torch.Tensor] = None,
                            mask: bool = False,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """dp (or dt with ``wrt_target``) of the layer for per-sample upstream
    ``uscale`` [B], optionally plus ``gin`` and masked by p > 0, in
    ``out_dtype`` (float32 or the inputs' dtype).  CUDA tensors launch
    kernel D's backward; CPU tensors run the plain version."""
    n = _check(p, t, "normalized_mse_backward")
    if p.device.type == "cpu":
        return normalized_mse_backward_reference(p, t, stats, uscale,
                                                 wrt_target, gin, mask,
                                                 out_dtype)
    out_dtype = out_dtype or p.dtype
    if out_dtype not in (torch.float32, p.dtype):
        raise ValueError(f"normalized_mse_backward: out_dtype {out_dtype} "
                         f"is neither float32 nor {p.dtype}")
    lib = _library()
    B, dev = p.shape[0], p.device
    p, t = _operand(p, p.dtype, p.shape), _operand(t, p.dtype, p.shape)
    stats = _operand(stats.float(), torch.float32, (B, 4))
    uscale = _operand(uscale.float().reshape(B), torch.float32, (B,))
    if gin is not None:
        gin = _operand(gin, torch.float32, p.shape)
    out = torch.empty(p.shape, dtype=out_dtype, device=dev)
    work = torch.empty(B * lib.nm_chunks(n), dtype=torch.float32, device=dev)
    err = lib.nm_backward(
        p.data_ptr(), t.data_ptr(), _DTYPES[p.dtype], B, n, stats.data_ptr(),
        uscale.data_ptr(), int(bool(wrt_target)),
        None if gin is None else gin.data_ptr(), int(bool(mask)),
        out.data_ptr(), int(out_dtype == torch.float32), work.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normalized-MSE backward kernel launch failed: "
                           f"CUDA error {err}")
    normalized_mse_backward.launches += 1
    return out


normalized_mse_backward.launches = 0


class _NormalizedMSE(torch.autograd.Function):
    """loss = sum(m w) / sum(w) with the closed-form backward; dp and dt
    are computed only when autograd asks for them."""

    @staticmethod
    def forward(ctx, p, t, weights, kernel: bool):
        fwd = (normalized_mse_forward if kernel
               else normalized_mse_forward_reference)
        m, stats = fwd(p, t)
        w = weights.float()
        wsum = w.sum()
        ctx.save_for_backward(p, t, stats, m, w, wsum)
        ctx.kernel = kernel
        return (m * w).sum() / wsum

    @staticmethod
    def backward(ctx, g):
        p, t, stats, m, w, wsum = ctx.saved_tensors
        bwd = (normalized_mse_backward if ctx.kernel
               else normalized_mse_backward_reference)
        uscale = g * w / wsum
        need = ctx.needs_input_grad
        dp = bwd(p, t, stats, uscale, False) if need[0] else None
        dt = bwd(p, t, stats, uscale, True) if need[1] else None
        dw = (g * (m * wsum - (m * w).sum()) / wsum ** 2) if need[2] else None
        return dp, dt, dw, None


def normalized_mse_reference(p: torch.Tensor, t: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """The plain version of one layer, [B, ...] maps and [B] weights ->
    scalar loss, gradients to p, t and weights (closed form)."""
    return _NormalizedMSE.apply(p, t, weights, False)


def normalized_mse_kernel(p: torch.Tensor, t: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """``normalized_mse_reference`` through kernel D on the card (the
    plain version on the CPU)."""
    return _NormalizedMSE.apply(p, t, weights, True)


def normalized_mse_cost(batch: int, n: int, itemsize: int) -> dict:
    """Work of one forward call: 'bytes' (p and t read once, m and stats
    written) and 'flops' (about 10 operations per element pair)."""
    return {"bytes": 2 * batch * n * itemsize + 20 * batch,
            "flops": 10 * batch * n}
