"""The readers of the program's own spans (``portbench/program.py`` and
its metric files): on synthetic contexts, without program spans, on
spans a CPU engine recorded, and the merged spans labelling the idle
gaps of a synthetic trace."""

import time

import numpy as np
import pytest
import torch

import pb_cells
from music_style_transfer_ldm_tpu_torch.utils import profiling
from portbench import core, program, tracing


def rec(name, start, end, device_ms=None, **attrs):
    return profiling.SpanRecord(name, start, end, 0, None, None, attrs,
                                device_ms)


H100 = "NVIDIA H100 80GB HBM3"
KERNEL_A = {"flops": 40.8e9, "bytes": 1e6}    # operations bound
SPANS = [
    # inside the window (10, 20), off the profiled sub-window (14, 16)
    rec("engine.readback", 11.0, 11.002),
    rec("engine.readback", 17.0, 17.004),
    rec("ldm.sample", 11.0, 11.2, device_ms=100.0),
    rec("ldm.sample", 12.0, 12.1, device_ms=150.0),
    rec("kernel_a", 12.0, 12.001, device_ms=4.125, **KERNEL_A),
    rec("kernel_a", 13.0, 13.001, device_ms=8.25, **KERNEL_A),
    rec("audio.nnls", 12.2, 12.3, device_ms=10.0),
    rec("audio.griffin_lim", 12.3, 12.4, device_ms=40.0),
    rec("audio.griffin_lim", 13.3, 13.4),          # no card: not counted
    rec("train.draws", 11.0, 11.001),
    rec("train.forward", 11.001, 11.02, device_ms=20.0),
    rec("train.backward", 11.02, 11.03, device_ms=10.0),
    rec("train.optimizer", 11.03, 11.04, device_ms=2.0),
    rec("train.draws", 12.0, 12.001),
    rec("train.forward", 12.001, 12.02, device_ms=22.0),
    rec("train.backward", 12.02, 12.03, device_ms=14.0),
    rec("train.optimizer", 12.03, 12.06, device_ms=3.0),
    # before the window, across its start, inside the sub-window, after
    rec("engine.readback", 9.0, 9.5),
    rec("ldm.sample", 9.9, 10.1, device_ms=1e3),
    rec("audio.nnls", 15.0, 15.1, device_ms=1e3),
    rec("train.draws", 15.5, 15.6),
    rec("train.optimizer", 15.7, 15.8, device_ms=1e3),
    rec("train.forward", 20.5, 20.6, device_ms=1e3),
]


def ctx_of(spans=SPANS):
    return {"device_kind": H100,
            "program": {"spans": spans, "counters": {}, "pending": 0,
                        "window": (10.0, 20.0), "exclude": (14.0, 16.0)}}


@pytest.mark.parametrize("name,want", [
    ("engine.readback_ms.fused", 3.0),
    ("engine.readback_ms.b128", 3.0),
    ("ldm.sample_device_ms.fused", 125.0),
    ("ldm.sample_device_ms.b128", 125.0),
    ("ldm.sample_launch_ms.b128", 150.0),
    ("fused_sampler_roofline.fused",
     100 * 2 * 40.8e9 / 989e12 / 12.375e-3),
    ("audio.nnls_device_ms.fused", 10.0),
    ("audio.nnls_device_ms.b128", 10.0),
    ("audio.griffin_lim_device_ms.fused", 40.0),
    ("audio.griffin_lim_device_ms.b128", 40.0),
    ("train.forward_device_ms.ldm", 21.0),
    ("train.backward_device_ms.ldm", 12.0),
    ("train.optimizer_device_ms.ldm", 2.5),
    ("train.step_launch_ms.ldm", 50.0)])
def test_reader_on_the_window_s_spans(name, want):
    assert core.reader(name)(ctx_of()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "engine.readback_ms.b128", "ldm.sample_device_ms.fused",
    "ldm.sample_launch_ms.b128", "fused_sampler_roofline.fused",
    "audio.nnls_device_ms.b128", "audio.griffin_lim_device_ms.fused",
    "train.forward_device_ms.ldm", "train.backward_device_ms.ldm",
    "train.optimizer_device_ms.ldm", "train.step_launch_ms.ldm"])
@pytest.mark.parametrize("ctx", ["none", "empty", "off_the_card"])
def test_reader_finds_nothing_without_program_spans(name, ctx):
    """An untraced run, a driver that turned no tracer on, and spans
    with no device interval read as nothing: None, not an error."""
    if ctx == "none":
        ctx = {"device_kind": H100, "stats": {"requests": 3}}
    elif ctx == "empty":
        ctx = ctx_of([])
    else:
        ctx = ctx_of([rec(r.name, r.start, r.end, **r.attrs)
                      for r in SPANS if not r.name.startswith("train.")])
    value = core.reader(name)(ctx)
    assert value is None or name in ("engine.readback_ms.b128",
                                     "ldm.sample_launch_ms.b128")


def test_the_roofline_needs_a_known_card():
    ctx = dict(ctx_of(), device_kind="cpu")
    assert core.reader("fused_sampler_roofline.fused")(ctx) is None


def test_on_and_off_around_a_cpu_dispatch():
    """The hooks' calls around real spans: the tracer is on only in a
    traced run, off() leaves it off, and host readers read the spans
    where the device readers, with no card, find nothing."""
    assert program.on(False) is None and profiling.active() is None
    tracer = program.on(True)
    try:
        assert profiling.active() is tracer
        t0 = time.perf_counter()
        with profiling.span("engine.readback"):
            np.ones(1000).sum()
        with profiling.span("ldm.sample", device=torch.device("cpu")):
            pass
        t1 = time.perf_counter()
    finally:
        prog = program.off(tracer, "cpu")
    assert profiling.active() is None
    assert prog["pending"] == 0 and prog["counters"] == {}
    assert [r.name for r in prog["spans"]] == ["engine.readback",
                                               "ldm.sample"]
    ctx = {"program": dict(prog, window=(t0, t1), exclude=None)}
    assert core.reader("engine.readback_ms.fused")(ctx) > 0.0
    assert core.reader("ldm.sample_device_ms.fused")(ctx) is None
    assert program.off(None, "cpu") is None


def test_merged_spans_label_idle_gaps_by_the_innermost():
    """A gap inside a harness span and a program span inside it takes
    the program span's name; one inside the harness span alone keeps the
    harness's name."""
    prof = tracing.Profile("cpu")
    prof.t0, prof.t1, prof.markers = 10.0, 10.010, [9.9999, 10.0102]

    def ev(ts, dur, name):
        return {"ph": "X", "cat": "kernel", "ts": ts, "dur": dur,
                "name": name}
    base = 5e6
    events = [ev(base + 9.9999e6, 1, "spin_kernel(long)"),
              ev(base + 10.000e6, 1000, "gemm"),      # gap 1-3 ms
              ev(base + 10.003e6, 1000, "gemm"),      # gap 4-8 ms
              ev(base + 10.008e6, 2000, "gemm"),
              ev(base + 10.0102e6, 1, "spin_kernel(long)")]
    spans = tracing.Spans()
    spans.records["audio.invert"].append((10.0005, 10.0095))
    program.merge(spans, {"spans": [
        rec("audio.griffin_lim", 10.0009, 10.0035),
        rec("engine.queue_wait", 10.0, 10.0101)]})
    program.merge(spans, None)
    gaps = dict(tracing.summarize(events, prof, spans)["idle_gaps"])
    assert gaps == pytest.approx({"audio.griffin_lim": 0.002,
                                  "audio.invert": 0.004})


def test_an_untraced_driver_run_leaves_no_program_spans():
    cell = pb_cells.serve_cell()
    run = core.driver(cell.traffic).run(cell, 2 ** 33 + 11, 1.0, False,
                                        "cpu", time.perf_counter())
    assert "program" not in run["ctx"]
    assert profiling.active() is None
