"""Spans from the harness's own files, and the profiler's view of a short
steady sub-window of a traced run.

``Spans`` times calls into the program's layers on the host clock (a
wrapper per layer boundary, put in place only in a traced run).
``Profile`` runs ``torch.profiler`` with CUDA activity only (CPU-op
recording would slow the host that paces these paths) over a sub-window
that the one thread launching the work opens and closes between two of
its launches (``tick``), after one empty session (``prime``) made before
any other thread launched work.  Marker kernels launched at known host
times put the spans on the trace's clock.  The trace reduces to the
device's busy time (the union of kernel, copy and set intervals), the
window's length, per-kernel totals, the top device operations and the
idle gaps labelled by the innermost host span around each.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

OUTSIDE = "host_outside_the_spans"
MARKER = "spin_kernel"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock records of calls, by span name."""

    def __init__(self):
        self.records: Dict[str, List[tuple]] = collections.defaultdict(list)
        self._lock = threading.Lock()
        self.exclude: Optional[tuple] = None   # (t0, t1) of the profile

    def wrap(self, name: str, fn: Callable, sync=None) -> Callable:
        """``fn`` timed as span ``name``; with ``sync`` (a device) the
        span ends after a synchronise of that device."""
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
            t1 = time.perf_counter()
            with self._lock:
                self.records[name].append((t0, t1))
            return out
        return timed

    def durations(self, name: str) -> List[float]:
        """Seconds of each call of ``name`` that does not overlap the
        profiled sub-window (the profiler's cost stays out)."""
        return [t1 - t0 for t0, t1 in self.records.get(name, [])
                if outside(t0, t1, self.exclude)]

    def all(self) -> List[tuple]:
        with self._lock:
            return [(t0, t1, n) for n, rs in self.records.items()
                    for t0, t1 in rs]


def outside(t0: float, t1: float, span: Optional[tuple]) -> bool:
    """Whether [t0, t1] misses ``span`` (None misses everything)."""
    return span is None or t1 <= span[0] or t0 >= span[1]


class Profile:
    """torch.profiler over [at, until] (host clock); ``tick`` opens and
    closes it, ``reduce`` reads it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.at = self.until = float("inf")
        self.t0 = self.t1 = None
        self.closed = None   # when closing (which holds its thread) ended
        self.markers: List[float] = []   # host times of the markers
        self._prof = None

    def prime(self) -> None:
        """A first, empty session in this thread before any other thread
        launches work: without it, a session started while another thread
        was launching kept none of that thread's kernels (torch 2.11)."""
        if self.device.type != "cuda":
            return
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.cuda._sleep(10)
            torch.cuda.synchronize(self.device)

    def schedule(self, at: float, seconds: float) -> None:
        self.at, self.until = at, at + seconds

    def tick(self) -> None:
        now = time.perf_counter()
        if self.t0 is None and now >= self.at:
            self.start()
        elif self.t0 is not None and self.t1 is None and now >= self.until:
            self.stop()

    def start(self) -> None:
        """Open the profile (on a CPU device only the times are kept:
        there is no device to trace)."""
        if self.device.type == "cuda":
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Close the profile, in the thread that opened it."""
        if self._prof is not None:
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._mark()
            torch.cuda.synchronize(self.device)
            self._prof.__exit__(None, None, None)
        self.closed = time.perf_counter()

    def _mark(self) -> None:
        """A marker kernel on an idle card, its launch time kept."""
        torch.cuda.synchronize(self.device)
        self.markers.append(time.perf_counter())
        torch.cuda._sleep(1000)

    def reduce(self, spans: Optional[Spans] = None) -> dict:
        """Read the trace once, after the measured window."""
        if self._prof is None:
            return summarize([], self, spans)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return summarize(events, self, spans)


def _clean(name: str) -> str:
    for ch in "<>(),: ":
        name = name.replace(ch, "_")
    while "__" in name:
        name = name.replace("__", "_")
    return name.strip("_")[:64]


def summarize(events: List[dict], profile: Profile,
              spans: Optional[Spans] = None) -> dict:
    """busy_s, window_s, kernels {name: [count, seconds]}, device_ops and
    idle_gaps (each the top 10 [name, seconds]) of a chrome trace; the
    window runs between the profile's two markers.  The trace does not
    always keep them (seen with torch 2.11 on the H100, the kernels of
    the thread around them kept): then the window runs from the first
    device event to the last, and the last event's end, which the
    synchronise before the profile's stop waited for, puts the host's
    clock on the trace's."""
    device = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    marker = sorted(d[0] for d in device if MARKER in d[2])
    device = [d for d in device if MARKER not in d[2]]
    empty = {"busy_s": 0.0, "window_s": 0.0, "kernels": {},
             "device_ops": [], "idle_gaps": []}
    if not device or len(profile.markers) != 2:
        return empty
    if len(marker) == 2:
        offset = marker[0] - profile.markers[0] * 1e6
        lo, hi = profile.t0 * 1e6 + offset, profile.t1 * 1e6 + offset
    else:
        lo = min(a for a, _, _ in device)
        hi = max(b for _, b, _ in device)
        offset = hi - profile.t1 * 1e6
    device = sorted((max(a, lo), min(b, hi), n) for a, b, n in device
                    if b > lo and a < hi)
    if not device:
        print("portbench: no device event inside the traced window",
              file=sys.stderr)
        return empty
    kernels: Dict[str, list] = {}
    ops: Dict[str, float] = collections.defaultdict(float)
    busy, gaps = 0.0, []
    cur_a, cur_b = lo, lo
    for a, b, n in device:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) * 1e-6
        ops[_clean(n)] += (b - a) * 1e-6
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if hi > cur_b:
        gaps.append((cur_b, hi))
    host = [(t0 * 1e6 + offset, t1 * 1e6 + offset, n)
            for t0, t1, n in (spans.all() if spans else [])]
    host = sorted((s for s in host if s[1] > lo and s[0] < hi),
                  key=lambda s: s[1] - s[0])
    by_span: Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = next((n for s0, s1, n in host if s0 <= mid <= s1), OUTSIDE)
        by_span[label] += (b - a) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": kernels, "device_ops": [list(x) for x in top],
            "idle_gaps": [list(x) for x in idle]}


def kernel_stats(summary: Optional[dict], *needles: str) -> tuple:
    """(count, seconds) of the kernels whose name holds any needle."""
    if not summary:
        return 0, 0.0
    count, secs = 0, 0.0
    for name, (c, s) in summary["kernels"].items():
        if any(n in name for n in needles):
            count += c
            secs += s
    return count, secs
