"""The program's own spans (``utils/profiling.py`` of the port) in a
traced run, for the drivers and the readers.

A driver's traced branch turns the program tracer on around its window
(``on``), turns it off and resolves its CUDA event pairs after the
closing synchronise (``off``), lays its spans beside the harness's
before ``Profile.reduce`` so that each idle gap names the innermost span
of either (``merge``), and hands them to the readers as
``ctx["program"]``, with the window and the profiled sub-window.  A
reader takes the spans of one name that lie inside the window and miss
the sub-window (``spans``), as ``Spans.durations`` does, and finds
nothing (None) in a context without program spans: an untraced run, a
driver that turns no tracer on, or a program without the tracer.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from portbench.tracing import Spans, outside


def on(trace: bool):
    """A program tracer, turned on, in a traced run (None otherwise, and
    where the program has none)."""
    if not trace:
        return None
    from music_style_transfer_ldm_tpu_torch.utils import profiling
    enable = getattr(profiling, "enable", None)
    return enable() if enable is not None else None


def off(tracer, device) -> Optional[dict]:
    """Turn ``tracer`` off; after a synchronise of ``device``, its spans
    (device time resolved), its counters and how many device intervals
    were still pending."""
    if tracer is None:
        return None
    from music_style_transfer_ldm_tpu_torch.utils import profiling
    profiling.disable()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    pending = tracer.resolve()
    return {"spans": tracer.spans(), "counters": dict(tracer.counters),
            "pending": pending}


def merge(spans: Spans, program: Optional[dict]) -> None:
    """Add the program's spans to the harness's, by name."""
    for r in (program or {}).get("spans", ()):
        spans.records[r.name].append((r.start, r.end))


def inside(program: dict, t0: float, t1: float) -> bool:
    """Whether [t0, t1] lies in the window and misses the sub-window."""
    w0, w1 = program["window"]
    return w0 <= t0 and t1 <= w1 and outside(t0, t1, program["exclude"])


def spans(ctx: dict, name: str) -> List:
    """The program's spans of ``name`` inside the window, off the
    profiled sub-window."""
    p = ctx.get("program")
    if not p:
        return []
    return [r for r in p["spans"]
            if r.name == name and inside(p, r.start, r.end)]


def host_ms(ctx: dict, name: str) -> Optional[float]:
    """Mean host milliseconds of the spans of ``name``."""
    d = [r.end - r.start for r in spans(ctx, name)]
    return 1e3 * float(np.mean(d)) if d else None


def device_ms(ctx: dict, name: str) -> Optional[float]:
    """Mean device milliseconds of the spans of ``name`` that ran on a
    card."""
    d = [r.device_ms for r in spans(ctx, name) if r.device_ms is not None]
    return float(np.mean(d)) if d else None
