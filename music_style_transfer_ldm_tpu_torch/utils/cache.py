"""The kernel build cache: the port's counterpart of XLA's persistent
compilation cache.  Each CUDA kernel is built by nvcc at first use and
kept under ``ops/_build.py build_dir()``, keyed by a hash of its source
and flags, so a warm directory makes every entry point start without a
build."""

from __future__ import annotations

import os
from pathlib import Path

from music_style_transfer_ldm_tpu_torch.ops._build import build_dir


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Create the kernel build directory and return its path (callers can
    look inside to tell a cold cache from a warm one).  A ``cache_dir``
    becomes the build directory of this process
    (``MSTLDM_KERNEL_BUILD_DIR``); otherwise it is ``build_dir()``.
    Builds nothing."""
    if cache_dir is not None:
        os.environ["MSTLDM_KERNEL_BUILD_DIR"] = str(cache_dir)
    path = Path(cache_dir) if cache_dir is not None else build_dir()
    path.mkdir(parents=True, exist_ok=True)
    return str(path)
