"""Tracing, step timing, stall warnings and numerical debugging.

* ``trace(log_dir)``: a ``torch.profiler`` trace (CPU, and the card's
  kernels when there is one) of whatever runs inside it, written as
  ``trace.json`` for chrome://tracing or Perfetto;
* ``StepTimer``: per-step wall-clock statistics (mean, p50, p95);
* ``StallWatchdog``: prints a recovery hint when a block of work (a
  training epoch) runs past a timeout;
* ``debug_mode()``: raises at the first module output holding a NaN or
  an Inf, and turns on autograd's anomaly detection for the backward.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch
from torch.nn.modules.module import register_module_forward_hook


@contextlib.contextmanager
def trace(log_dir: str | Path = "runs/profile") -> Iterator:
    """Profile the block; yields the profiler, writes
    ``<log_dir>/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _tensors(v)


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = True) -> Iterator[None]:
    """Raise FloatingPointError at the first module whose output holds a
    NaN (``nans``) or an Inf (``infs``); autograd's anomaly detection
    names the backward op that makes a NaN.  Each check reads the tensor
    back to the host, so this is for finding a fault, not for training."""
    def check(module, _inputs, output):
        for t in _tensors(output):
            if not t.is_floating_point():
                continue
            if nans and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"NaN in the output of {type(module).__name__}")
            if infs and bool(torch.isinf(t).any()):
                raise FloatingPointError(
                    f"Inf in the output of {type(module).__name__}")

    handle = register_module_forward_hook(check)
    try:
        with torch.autograd.detect_anomaly(check_nan=nans):
            yield
    finally:
        handle.remove()


class StepTimer:
    """Wall-clock step timing with a percentile summary.  Work on the card
    is asynchronous: time a block that ends in a synchronise."""

    def __init__(self):
        self.samples: list[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> dict:
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {"steps": len(a), "mean_s": float(a.mean()),
                "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)),
                "total_s": float(a.sum())}


class StallWatchdog:
    """Prints a warning when the ``with`` block runs longer than
    ``timeout_s``.  A call blocked on the card cannot be interrupted
    safely from inside the process, so the watchdog makes the stall
    visible and says how to recover, and calls ``on_stall`` if given.

        with StallWatchdog(timeout_s=600, context="AE epoch 3"):
            ... one epoch ...
    """

    def __init__(self, timeout_s: float = 300.0, context: str = "",
                 on_stall=None):
        self.timeout_s = timeout_s
        self.context = context
        self.on_stall = on_stall
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self):
        self.fired = True
        print(f"WATCHDOG: no progress for {self.timeout_s:.0f}s"
              + (f" in {self.context}" if self.context else "")
              + ": likely a stalled device call. Safe recovery: kill this "
              "process and resume from the latest checkpoint (train "
              "--resume-from <ckpt>).", flush=True)
        if self.on_stall is not None:
            self.on_stall()

    def __enter__(self):
        self.fired = False
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        return False
