"""Tracing, step timing, stall warnings and numerical debugging.

* ``span``, ``record`` and ``count``: the program's own spans and
  counters, kept by a ``Tracer`` once ``enable`` has turned one on (off
  by default; see below);
* ``trace(log_dir)``: a ``torch.profiler`` trace (CPU, and the card's
  kernels when there is one) of whatever runs inside it, written as
  ``trace.json`` for chrome://tracing or Perfetto;
* ``StepTimer``: per-step wall-clock statistics (mean, p50, p95);
* ``StallWatchdog``: prints a recovery hint when a block of work (a
  training epoch) runs past a timeout;
* ``debug_mode()``: raises at the first module output holding a NaN or
  an Inf, and turns on autograd's anomaly detection for the backward.

The program tracer.  The engine, the model step, kernel A's launch, the
audio inversion, the LDM trainer and the device loader open named spans
(``span``) where their work happens; ``count`` adds to a named counter.
Nothing is kept until code turns a tracer on::

    tracer = profiling.enable()          # a Tracer, or enable(Tracer(n))
    ... serve or train ...
    torch.cuda.synchronize()
    profiling.disable()
    tracer.resolve()                     # CUDA event pairs -> device ms
    for r in tracer.spans("audio.griffin_lim"):
        print(r.end - r.start, r.device_ms)

While it is off, ``span`` returns one shared no-op context and ``count``
returns after reading one module global.  A span keeps its name, its
start and end on ``time.perf_counter`` (the clock of the host's other
timers), its id, its parent's id (the innermost span open on the same
thread) and its attributes; one that ``record`` keeps may carry a trace
id (the engine's: the request's).  A span opened with a CUDA ``device``
also records a CUDA event pair on that device's current stream at its
start and end; nothing synchronises, and after the caller has
synchronised, ``Tracer.resolve`` turns each pair into device
milliseconds (``None`` where the span ran on no card).
A tracer keeps its newest ``capacity`` spans and drops the oldest first.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.nn.modules.module import register_module_forward_hook


@dataclasses.dataclass(slots=True)
class SpanRecord:
    """One closed span; times in ``time.perf_counter`` seconds."""

    name: str
    start: float
    end: float
    span_id: int
    parent_id: Optional[int]
    trace_id: Any
    attrs: Dict[str, Any]
    device_ms: Optional[float] = None
    events: Optional[tuple] = None   # CUDA (start, end) until resolved


class Tracer:
    """The spans (newest ``capacity``) and counters of a traced stretch."""

    def __init__(self, capacity: int = 1 << 16):
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _add(self, name: str, n) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        """The kept spans, in the order they closed (of ``name`` only,
        if given)."""
        return [r for r in list(self.records)
                if name is None or r.name == name]

    def resolve(self) -> int:
        """Device milliseconds of every span whose end event has
        completed (call it after a synchronise); returns how many are
        still pending."""
        pending = 0
        for r in list(self.records):
            if r.events is None:
                continue
            start, end = r.events
            if end.query():
                r.device_ms = start.elapsed_time(end)
                r.events = None
            else:
                pending += 1
        return pending


class _Span:
    __slots__ = ("_tracer", "_rec", "_stream", "_start")

    def __init__(self, tracer: Tracer, name: str,
                 device: Optional[torch.device], attrs: dict):
        self._tracer = tracer
        self._stream = (torch.cuda.current_stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self._rec = SpanRecord(name, 0.0, 0.0, 0, None, None, attrs)

    def set(self, **attrs) -> None:
        """Add attributes to the span."""
        self._rec.attrs.update(attrs)

    def __enter__(self):
        rec, stack = self._rec, self._tracer._stack()
        rec.span_id = next(self._tracer._ids)
        rec.parent_id = stack[-1] if stack else None
        stack.append(rec.span_id)
        if self._stream is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
        rec.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        rec.end = time.perf_counter()
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            rec.events = (self._start, end)
        self._tracer._stack().pop()
        self._tracer.records.append(rec)
        return False


class _NoSpan:
    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()
_TRACER: Optional[Tracer] = None


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Turn the program tracer on (a new ``Tracer`` unless one is given);
    returns it."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Turn the program tracer off; returns the tracer that was on.
    Spans open at that moment still close into it."""
    global _TRACER
    tracer, _TRACER = _TRACER, None
    return tracer


def active() -> Optional[Tracer]:
    """The tracer that is on, or None."""
    return _TRACER


def span(name: str, device: Optional[torch.device] = None, **attrs):
    """A context that records span ``name`` while a tracer is on (the
    shared no-op otherwise); with a CUDA ``device`` it times the span on
    that device's current stream as well."""
    tracer = _TRACER
    if tracer is None:
        return _NOOP
    return _Span(tracer, name, device, attrs)


def record(name: str, start: float, end: float, trace_id=None,
           **attrs) -> None:
    """Keep a span its caller timed (``time.perf_counter`` seconds), such
    as a wait that starts on one thread and ends on another."""
    tracer = _TRACER
    if tracer is None:
        return
    stack = tracer._stack()
    tracer.records.append(SpanRecord(
        name, start, end, next(tracer._ids), stack[-1] if stack else None,
        trace_id, attrs))


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while a tracer is on."""
    tracer = _TRACER
    if tracer is None:
        return
    tracer._add(name, n)


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
        self._stalled = threading.Event()

    @property
    def fired(self) -> bool:
        """Whether the warning went out (and ``on_stall`` returned)."""
        return self._stalled.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the watchdog has fired (or ``timeout`` s passed);
        returns ``fired``."""
        return self._stalled.wait(timeout)

    def _fire(self):
        print(f"WATCHDOG: no progress for {self.timeout_s:.0f}s"
              + (f" in {self.context}" if self.context else "")
              + ": likely a stalled device call. Safe recovery: kill this "
              "process and resume from the latest checkpoint (train "
              "--resume-from <ckpt>).", flush=True)
        try:
            if self.on_stall is not None:
                self.on_stall()
        finally:
            self._stalled.set()

    def __enter__(self):
        self._stalled.clear()
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()
        return False
