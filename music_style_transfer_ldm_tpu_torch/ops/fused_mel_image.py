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

The kernel sums each mel row over its band of nonzero bins only
(``mel_bands``), in row groups balanced by band width (``row_groups``)
spread over the SMs.  Products with a zero coefficient are skipped, so a
non-finite spectrum value outside a row's band does not reach that row
(the plain version's dense product makes it NaN); the STFT of finite
audio is finite.  The wrapper keeps a filterbank's bands and groups,
keyed on its data pointer, version, shape and device.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio.mel import power_to_db
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    db_to_unit_image,
)
from music_style_transfer_ldm_tpu_torch.ops._build import build_library
from music_style_transfer_ldm_tpu_torch.ops._launch import (
    stream_handle, tickets,
)

# The kernel's frame tile (a multiple of 32) and largest row group, set
# here and compiled into csrc/fused_mel_image.cu as kTileT and kMaxRows;
# and how many row groups the planner aims for: at T <= 160, the CTAs of
# one item.
TILE_FRAMES = 160
MAX_ROWS = 24
GROUP_TARGET = 64
# No mul+add contraction: the epilogue rounds each op as the plain
# version does (the product's fmas are explicit in the source).
_FLAGS = ("--fmad=false", f"-DMEL_TILE_T={TILE_FRAMES}",
          f"-DMEL_MAX_ROWS={MAX_ROWS}")


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


def mel_bands(fb: torch.Tensor) -> torch.Tensor:
    """Each row's band of nonzero columns: int32 [n_mels, 2] of (first
    nonzero column, one past the last) on fb's device; (0, 0) for an
    all-zero row.  NaN counts as nonzero."""
    nz = fb != 0
    F = fb.shape[1]
    col = torch.arange(F, device=fb.device)
    lo = torch.where(nz, col, F).amin(1)
    hi = torch.where(nz, col + 1, 0).amax(1)
    return torch.stack([torch.minimum(lo, hi), hi], 1).to(torch.int32)


def row_groups(bands: np.ndarray) -> np.ndarray:
    """Consecutive rows in groups of about sum(width) / GROUP_TARGET bins
    each (a row wider than that alone; at most MAX_ROWS rows): int32
    [G, 4] of (row0, row1, bin_lo, bin_hi), the bins the union of the
    group's bands ((0, 0) when every band in it is empty)."""
    bands = np.asarray(bands, np.int64)
    width = np.maximum(bands[:, 1] - bands[:, 0], 0)
    cap = max(1, -(-int(width.sum()) // GROUP_TARGET))
    bounds, start, acc = [], 0, 0
    for m, w in enumerate(width):
        if m > start and (acc + w > cap or m - start == MAX_ROWS):
            bounds.append((start, m))
            start, acc = m, 0
        acc += int(w)
    bounds.append((start, len(width)))
    out = []
    for r0, r1 in bounds:
        live = bands[r0:r1][width[r0:r1] > 0]
        lo, hi = ((int(live[:, 0].min()), int(live[:, 1].max()))
                  if len(live) else (0, 0))
        out.append((r0, r1, lo, hi))
    return np.asarray(out, np.int32).reshape(-1, 4)


def build_fused_mel_image() -> dict:
    """Compile csrc/fused_mel_image.cu (ops/_build.py)."""
    return build_library("fused_mel_image.cu", _FLAGS)


@functools.cache
def _library():
    lib = ctypes.CDLL(build_fused_mel_image()["path"])
    lib.fused_mel_unit_image.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p])
    lib.fused_mel_unit_image.restype = ctypes.c_int
    return lib


_PLANS: collections.OrderedDict = collections.OrderedDict()


def _plan(fb: torch.Tensor) -> dict:
    """A filterbank's bands and row groups on its device, kept per (data
    pointer, version, shape, device); the entry holds fb, so its memory
    is not reused under the key while the entry lives."""
    key = (fb.data_ptr(), fb._version, tuple(fb.shape), fb.device)
    plan = _PLANS.get(key)
    if plan is None:
        bands = mel_bands(fb)
        groups = row_groups(bands.cpu().numpy())
        plan = {"fb": fb, "bands": bands.contiguous(),
                "groups": torch.as_tensor(groups, device=fb.device),
                "n_groups": len(groups),
                "max_rows": int((groups[:, 1] - groups[:, 0]).max())}
        _PLANS[key] = plan
        while len(_PLANS) > 8:
            _PLANS.popitem(last=False)
    return plan


def mel_image_grid(fb: torch.Tensor, T: int) -> dict:
    """The kernel's grid for filterbank ``fb`` and T frames (its launch
    plan): row groups, frame tiles and CTAs per item, and the
    band-limited multiply-adds per item (sum of band widths x T)."""
    plan = _plan(fb)
    bands = plan["bands"].cpu()
    tiles = -(-T // TILE_FRAMES)
    return {"groups": plan["n_groups"], "tiles": tiles,
            "ctas_per_item": plan["n_groups"] * tiles,
            "band_macs": int((bands[:, 1] - bands[:, 0]).sum()) * T}


def mel_image_band_cost(fb: torch.Tensor, T: int, batch: int) -> dict:
    """Work of one call that the function needs for this filterbank, its
    band-limited count: 'flops' (2 per multiply-add over each row's band)
    and 'bytes' (f32: the band coefficients and the spectra's bins in the
    union of the bands read once, the image written once)."""
    bands = mel_bands(fb).cpu()
    width = (bands[:, 1] - bands[:, 0]).clamp(min=0)
    bins = torch.zeros(fb.shape[1], dtype=torch.bool)
    for lo, hi in bands.tolist():
        bins[lo:hi] = True
    coefs = int(width.sum())
    return {"flops": 2 * coefs * T * batch,
            "bytes": 4 * (coefs + batch * (int(bins.sum()) * T
                                           + fb.shape[0] * T))}


def _launch(fb, power_spec, max_db, top_db, quantize):
    lib = _library()
    plan = _plan(fb)
    if fb.dtype is not torch.float32 or not fb.is_contiguous():
        fb = fb.float().contiguous()
    # the spectra in their own strides (the STFT's are frame-major)
    spec = (power_spec if power_spec.dtype is torch.float32
            else power_spec.float())
    B, F, T = spec.shape
    M = fb.shape[0]
    dev = spec.device
    # the image and the CTAs' maxima in one allocation
    per_item = plan["n_groups"] * -(-T // TILE_FRAMES)
    buf = torch.empty(B * (M * T + per_item), dtype=torch.float32,
                      device=dev)
    stream = stream_handle(dev)
    out = buf.data_ptr()
    err = lib.fused_mel_unit_image(
        fb.data_ptr(), spec.data_ptr(), *spec.stride(),
        plan["bands"].data_ptr(), plan["groups"].data_ptr(),
        plan["n_groups"], plan["max_rows"], out, out + 4 * B * M * T,
        tickets(dev, stream, B).data_ptr(), B, M, F, T, float(max_db),
        float(top_db), float(np.float32(255.0 / max_db)),
        int(bool(quantize)), stream)
    if err != 0:
        raise RuntimeError(f"fused mel image kernel launch failed: CUDA "
                           f"error {err}")
    fused_mel_unit_image.launches += 1
    return buf[:B * M * T].view(B, M, T)


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
    """Work of one call, counted dense: 'flops' (2 per multiply-add of
    FB . S) and 'bytes' (FB and S read once, the image written once,
    f32).  The band-limited count is ``mel_image_band_cost``'s."""
    return {"flops": 2 * n_mels * F * T * batch,
            "bytes": 4 * (n_mels * F + batch * (F * T + n_mels * T))}
