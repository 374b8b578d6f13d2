"""Device selection, the fused-route bucket limit, exact float32,
deterministic convolutions.

Entry points default to ``device="cuda"`` and raise when there is no
card: there is no silent CPU path.  Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import os

import torch

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
