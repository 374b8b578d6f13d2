"""Mel projection -> per-item dB -> uint8-grid image as one CUDA kernel
(kernel C).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/fused_mel_image.py``
``fused_mel_unit_image``.  Per item: mel = FB . S, ref = max(mel),
dB = 10 log10(max(mel, 1e-10)) - 10 log10(ref) clipped at -top_db, then
the uint8 grid and / 255.  This is the port's front end: every WAV input
becomes model images here (``audio/processor.py``).

On a CUDA tensor the wrapper launches ``csrc/fused_mel_image.cu`` (built
with nvcc at first use, bound with ctypes; the source explains the
design and the bound); on a CPU tensor it runs
``fused_mel_unit_image_reference``, the plain PyTorch chain einsum ->
``power_to_db`` -> ``db_to_unit_image``; on any other device it raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio.mel import power_to_db
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    db_to_unit_image,
)
from music_style_transfer_ldm_tpu_torch.ops._build import build_library

# No mul+add contraction: the epilogue rounds each op as the plain
# version does (the product's fmas are explicit in the source).
_FLAGS = ("--fmad=false",)


def fused_mel_unit_image_reference(fb: torch.Tensor,
                                   power_spec: torch.Tensor,
                                   max_db: float = 80.0,
                                   top_db: float = 80.0,
                                   quantize: bool = True) -> torch.Tensor:
    """Plain PyTorch version: fb [n_mels, F], power_spec [B, F, T] ->
    [B, n_mels, T] f32 in [0, 1]."""
    mel = torch.einsum("mf,bft->bmt", fb.float(), power_spec.float())
    db = power_to_db(mel, top_db=top_db, batched=True)
    return db_to_unit_image(db, max_db=max_db, quantize=quantize)


def build_fused_mel_image() -> dict:
    """Compile csrc/fused_mel_image.cu (ops/_build.py)."""
    return build_library("fused_mel_image.cu", _FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(build_fused_mel_image()["path"])
    lib.fused_mel_unit_image.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    lib.fused_mel_unit_image.restype = ctypes.c_int
    return lib


def _launch(fb, power_spec, max_db, top_db, quantize):
    lib = _library()
    fb = fb.float().contiguous()
    spec = power_spec.float().contiguous()
    B, F, T = spec.shape
    out = torch.empty((B, fb.shape[0], T), dtype=torch.float32,
                      device=spec.device)
    stream = torch.cuda.current_stream(spec.device).cuda_stream
    err = lib.fused_mel_unit_image(
        fb.data_ptr(), spec.data_ptr(), out.data_ptr(), B, fb.shape[0], F, T,
        float(max_db), float(top_db), float(np.float32(255.0 / max_db)),
        int(bool(quantize)), stream)
    if err != 0:
        raise RuntimeError(f"fused mel image kernel launch failed: CUDA "
                           f"error {err}")
    fused_mel_unit_image.launches += 1
    return out


def fused_mel_unit_image(fb: torch.Tensor, power_spec: torch.Tensor,
                         max_db: float = 80.0, top_db: float = 80.0,
                         quantize: bool = True) -> torch.Tensor:
    """fb [n_mels, F], power_spec [B, F, T] -> [B, n_mels, T] f32 in
    [0, 1].  CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    if fb.ndim != 2 or power_spec.ndim != 3 or (
            fb.shape[1] != power_spec.shape[1]):
        raise ValueError(f"fb {tuple(fb.shape)} and power_spec "
                         f"{tuple(power_spec.shape)} do not fit [n_mels, F] "
                         "x [B, F, T]")
    if fb.device != power_spec.device:
        raise ValueError(f"fb on {fb.device}, power_spec on "
                         f"{power_spec.device}")
    if power_spec.device.type == "cpu":
        return fused_mel_unit_image_reference(fb, power_spec, max_db,
                                              top_db, quantize)
    if power_spec.device.type != "cuda":
        raise RuntimeError(f"fused_mel_unit_image: no kernel for "
                           f"{power_spec.device}")
    return _launch(fb, power_spec, max_db, top_db, quantize)


fused_mel_unit_image.launches = 0


def mel_image_cost(n_mels: int, F: int, T: int, batch: int) -> dict:
    """Work of one call: 'flops' (2 per multiply-add of FB . S) and
    'bytes' (FB and S read once, the image written once, f32)."""
    return {"flops": 2 * n_mels * F * T * batch,
            "bytes": 4 * (n_mels * F + batch * (F * T + n_mels * T))}
