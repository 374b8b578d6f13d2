"""Device selection, the card's published peak rates, the fused-route
bucket limit, the benchmark's chain length, exact float32, deterministic
convolutions.

Entry points default to ``device="cuda"`` and raise when there is no
card: there is no silent CPU path.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

# Published dense peaks (no sparsity) from NVIDIA's H100 Tensor Core GPU
# datasheet: bf16 tensor-core FLOP/s and HBM bytes/s.  Substring keys
# matched against the card's name (``torch.cuda.get_device_name``),
# lower-cased, most specific first; the SXM5 part reports itself as
# "NVIDIA H100 80GB HBM3".  Published figures, not measurements.
PEAK_BF16_FLOPS: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),
)
HBM_BYTES_PER_SEC: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 2.0e12),
    ("h100 nvl", 3.9e12),
    ("h100", 3.35e12),
)


def _lookup(table, device_kind) -> Optional[float]:
    kind = str(device_kind or "").lower()
    for key, value in table:
        if key in kind:
            return value
    return None


def peak_flops_per_sec(device_kind) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the card named ``device_kind``, or None
    for an unknown device (the CPU)."""
    return _lookup(PEAK_BF16_FLOPS, device_kind)


def hbm_bytes_per_sec(device_kind) -> Optional[float]:
    """HBM bytes/s of the card named ``device_kind``, or None for an
    unknown device (the CPU)."""
    return _lookup(HBM_BYTES_PER_SEC, device_kind)

# Largest bucket routed to the fused trajectory kernel (override:
# MSTLDM_FUSED_BUCKET_MAX).  Measured on an NVIDIA H100 80GB HBM3 at
# 700 W by chip_smoke.py (bf16, 49 steps): kernel A beats the scan route
# at every bucket it takes, 1 to FUSED_MAX_BATCH = 8 (about 6 ms against
# 75-120 ms per trajectory), so there is no crossover below 8.
_DEFAULT_FUSED_BUCKET_MAX = 8


def fused_bucket_max() -> int:
    """Largest batch the engine sends to the fused trajectory kernel."""
    env = os.environ.get("MSTLDM_FUSED_BUCKET_MAX")
    if env:
        return max(1, int(env))
    return _DEFAULT_FUSED_BUCKET_MAX


def bench_chain_len(device_kind: Optional[str] = None,
                    base: int = 32) -> int:
    """Dependent-call chain length of ``benchmarks.py``'s device-time
    windows: the number of 49-step B=1 trajectories of kernel A that one
    pair of CUDA events brackets.

    The window only has to be long against the few microseconds by which
    a launch, and so an event, can land late.  On an NVIDIA H100 80GB
    HBM3 at 700 W kernel A takes 4.43-4.47 ms a trajectory (chip_smoke.py
    phase 7), so 32 trajectories make a window of about 142 ms.  The
    length is ``base`` on every device: a trajectory's time is set by
    its 735 grid barriers, not by the card's peak, so no peak ratio
    predicts it on another card.  ``device_kind`` is taken for the JAX
    package's signature and changes nothing."""
    del device_kind
    return base


@contextlib.contextmanager
def exact_float32(device: torch.device):
    """float32 as written: autocast off and TF32 convolutions off while
    the block runs (cuDNN's default TF32 keeps about three digits)."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.autocast(torch.device(device).type, enabled=False):
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms (and no autotuning) while the
    block runs, then the process's settings again: the default algorithms
    use atomics, so a seeded request run twice moved its image by an ulp
    and, through Griffin-Lim, its audio by up to 1.5e-3.  Scoped, so the
    trainers in the same process keep their own settings; TF32 is left as
    the process has it.  Usable as a decorator."""
    with torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True,
            allow_tf32=torch.backends.cudnn.allow_tf32):
        yield


def resolve_device(device="cuda") -> torch.device:
    """The requested device, or an error if it is a CUDA device and no
    card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "explicitly to run the plain PyTorch versions on the CPU")
    return device
