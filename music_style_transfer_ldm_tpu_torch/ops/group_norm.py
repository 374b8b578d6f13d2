"""GroupNorm over channels-last tensors as a CUDA kernel, with SiLU and a
per-(item, channel) addend fused in.

Replaces no TPU kernel (the JAX package's models have no GroupNorm): it
serves Riffusion's UNet and VAE (``models/sd_layers.py``, ``sd_unet.py``,
``vae_kl.py``), whose activations are channels-last on the card.

``group_norm_nhwc(x, weight, bias, groups, eps, silu=False, add=None)``
computes, for x [N, C, H, W],

    v = x + add[:, :, None, None]     rounded to x's type (when add given)
    y = group_norm(v, groups, weight, bias, eps)
    y = silu(y)                       (when silu)

On a CUDA tensor it launches ``csrc/group_norm_nhwc.cu`` (built with nvcc
at first use, bound with ctypes; the source explains the design and the
bound): x must be channels-last and f32 or bf16 (weight, bias and add
are read in x's type), and y comes back channels-last in x's type,
rounded once.  It never falls back: an NCHW CUDA tensor, or C not a
multiple of ``groups``, raises.  On a CPU tensor it runs the plain
version (``group_norm_nhwc_reference``), which keeps a channels-last
input's layout.  Every call adds one to the tracer's counter
``group_norm.calls``; a call that launches the kernel pair (its
statistics and its apply pass) adds one to ``group_norm_nhwc.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from music_style_transfer_ldm_tpu_torch.ops._build import build_library
from music_style_transfer_ldm_tpu_torch.ops._launch import (
    stream_handle, tickets,
)
from music_style_transfer_ldm_tpu_torch.utils.profiling import count

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def group_norm_nhwc_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int,
                              eps: float, silu: bool = False,
                              add: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version: the add (rounded to x's type), then
    ``F.group_norm``, then ``F.silu``; y in x's layout."""
    if add is not None:
        x = x + add.to(x.dtype)[:, :, None, None]
    y = F.group_norm(x, groups, weight, bias, eps)
    if silu:
        y = F.silu(y)
    if x.is_contiguous(memory_format=torch.channels_last):
        y = y.contiguous(memory_format=torch.channels_last)
    return y


def build_group_norm() -> dict:
    """Compile csrc/group_norm_nhwc.cu (ops/_build.py)."""
    return build_library("group_norm_nhwc.cu")


@functools.cache
def _library():
    lib = ctypes.CDLL(build_group_norm()["path"])
    lib.group_norm_nhwc.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p])
    lib.group_norm_nhwc.restype = ctypes.c_int
    lib.group_norm_nhwc_max_chunks.restype = ctypes.c_int
    lib.max_chunks = lib.group_norm_nhwc_max_chunks()
    return lib


def _like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t on x's device in x's type, contiguous."""
    if t.dtype == x.dtype and t.device == x.device and t.is_contiguous():
        return t
    return t.to(device=x.device, dtype=x.dtype).contiguous()


def group_norm_nhwc(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, groups: int, eps: float,
                    silu: bool = False, add: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """GroupNorm of x [N, C, H, W] (then SiLU when ``silu``), with
    ``add`` [N, C] added to x first; see the module's docstring."""
    count("group_norm.calls")
    dev = x.device
    if dev.type == "cpu":
        return group_norm_nhwc_reference(x, weight, bias, groups, eps, silu,
                                         add)
    if dev.type != "cuda":
        raise RuntimeError(f"group_norm_nhwc: no kernel for {dev}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_nhwc: x must be 4-d f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    N, C, H, W = x.shape
    if C % groups:
        raise ValueError(f"group_norm_nhwc: {C} channels in {groups} groups")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_nhwc: x must be channels-last on the "
                         "card")
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"group_norm_nhwc: weight and bias must be ({C},)")
    if add is not None:
        if add.shape != (N, C):
            raise ValueError(f"group_norm_nhwc: add must be {(N, C)}, got "
                             f"{tuple(add.shape)}")
        add = _like(add, x)
    weight, bias = _like(weight, x), _like(bias, x)
    lib = _library()
    stream = stream_handle(dev)
    scratch = torch.empty(N * groups * (2 + 3 * lib.max_chunks),
                          dtype=torch.float32, device=dev)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    err = lib.group_norm_nhwc(
        x.data_ptr(), y.data_ptr(), _DTYPES[x.dtype], weight.data_ptr(),
        bias.data_ptr(), None if add is None else add.data_ptr(),
        scratch.data_ptr(), tickets(dev, stream, N).data_ptr(), N, C, H * W,
        groups, eps, silu, stream)
    if err == -1:
        raise ValueError(f"group_norm_nhwc: the kernel takes no {C} "
                         f"channels in {x.dtype}")
    if err != 0:
        raise RuntimeError(f"group_norm_nhwc kernel launch failed: CUDA "
                           f"error {err}")
    group_norm_nhwc.launches += 1
    return y


group_norm_nhwc.launches = 0
