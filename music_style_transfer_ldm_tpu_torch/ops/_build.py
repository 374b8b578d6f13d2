"""Build a CUDA source of ``csrc/`` into a shared library with nvcc.

Every kernel of the port is compiled on the machine with the card, at
first use, for ``sm_90a``, into a plain-C shared library that its wrapper
binds with ctypes (no PyTorch headers, so a build takes seconds).  The
library is cached by a hash of the source and the flags, under
``MSTLDM_KERNEL_BUILD_DIR`` or else ``build/kernels`` at the root of the
checkout (listed in .gitignore).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def build_dir() -> Path:
    """Where built kernels go."""
    return Path(os.environ.get(
        "MSTLDM_KERNEL_BUILD_DIR",
        Path(__file__).resolve().parents[2] / "build" / "kernels"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def build_library(source: str, flags: Sequence[str] = ()) -> dict:
    """Compile ``csrc/<source>`` for sm_90a (cached by source and flag
    hash).  Returns {'path', 'seconds', 'log'}; 'log' holds ptxas's
    register and spill report of a fresh build."""
    src_path = CSRC / source
    flags = list(flags)
    digest = hashlib.sha1(src_path.read_bytes())
    digest.update(" ".join(flags).encode())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src_path.stem}_{digest.hexdigest()[:12]}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": "(cached)"}
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *flags,
           "-o", str(tmp), str(src_path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds,
            "log": proc.stdout + proc.stderr}
