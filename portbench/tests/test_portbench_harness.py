"""The harness is driven by data, keeps to the benchmark's contract, and
refuses to run without a card.

The data test copies portbench/ and BENCHMARK.json to a temporary
folder, adds a configuration, a traffic mix, a metric reader and a
workload entry as new files only, and runs the new cell at a small size
on the CPU through the harness's internal entry (``core.run_cell``), in
a fresh process so that nothing of this one leaks in.
"""

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import core

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha1(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


RUN_NEW_CELL = r"""
import json, sys, time
sys.path[0:0] = [sys.argv[1], sys.argv[2]]
from pathlib import Path
from portbench import core
base = Path(sys.argv[1])
assert core.__file__.startswith(sys.argv[1]), core.__file__
cell = core.load_cell("serve-tiny-closed", base / "BENCHMARK.json", base)
result = core.run_cell(cell, 2 ** 35 + 3, 1.5, False, "cpu",
                       time.perf_counter(), base / "portbench" )
print(json.dumps({"result": result, "forbidden": core.forbidden_modules()}))
"""


def test_a_new_cell_is_new_files_only(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "ldm-ref-fused.json").read_text())
    cfg["name"] = "ldm-tiny"
    cfg["serve"]["steps"] = 3
    (pb / "configs" / "ldm-tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "closed-c2-b2.json").write_text(json.dumps({
        "kind": "serve", "loop": "closed", "clients": 2, "buckets": [1, 2],
        "max_wait_ms": 5.0, "pool": 4, "preroll_s": 0.3,
        "check": {"share": 1.0, "max": 2}}))
    (pb / "metrics" / "served_clips.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx['completed'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ldm-tiny", "source": "x",
                             "file": "portbench/configs/ldm-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "serve-tiny-closed",
                               "config": "ldm-tiny",
                               "traffic": "closed-c2-b2", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({
        "name": "served_clips.tiny", "unit": "clips", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["serve-tiny-closed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", RUN_NEW_CELL, str(tmp_path), str(ROOT)],
        capture_output=True, text=True, timeout=900, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    result = got["result"]
    assert got["forbidden"] == []
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"served_clips.tiny", "setup_s"}
    assert result["metrics"]["served_clips.tiny"]["value"] >= 1
    after = digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


ECHO_DRIVER = r"""
from portbench.state import device_info, limits
import torch


def run(cell, seed, seconds, trace, device, t0):
    checks = {k: {"value": 0.0, "limit": v}
              for k, v in limits(cell).items()}
    ctx = {"kind": "echo", "setup_s": 0.5, "window_s": seconds,
           "echoed": cell.traffic["echoes"]}
    return {"attempted": 1, "failed": 0, "ctx": ctx, "checks": checks,
            "device": device_info(torch.device(device), cell.chips)}


def control(cell, sample, seed, device):
    return {}
"""

RUN_NEW_KIND = r"""
import json, sys, time
sys.path[0:0] = [sys.argv[1], sys.argv[2]]
from pathlib import Path
from portbench import core
base = Path(sys.argv[1])
cell = core.load_cell("echo-cell", base / "BENCHMARK.json", base)
for trace in (False, True):
    print(json.dumps(core.run_cell(cell, 2 ** 35 + 5, 2.0, trace, "cpu",
                                   time.perf_counter(), base / "portbench")))
"""


def test_a_new_kind_of_cell_is_a_new_driver_file(tmp_path):
    """A mix whose ``kind`` names a new driver file runs through it, its
    limits in the mix, and a per-cell metric finds the reader of its
    base name."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    pb = tmp_path / "portbench"
    before = digest(pb)
    (pb / "drivers" / "echo.py").write_text(ECHO_DRIVER)
    (pb / "traffic" / "echo-3.json").write_text(json.dumps(
        {"kind": "echo", "echoes": 3, "limits": {"echo_gap": 0.0}}))
    (pb / "metrics" / "echoes_per_s.py").write_text(
        "def read(ctx):\n    return ctx['echoed'] / ctx['window_s']\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "echo-cell", "config": "ldm-ref",
                               "traffic": "echo-3", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({
        "name": "echoes_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["echo-cell"]})
    bench["per_layer"].append({
        "name": "echoes_per_s.echo", "unit": "1/s", "better": "higher",
        "source": "program_counter", "layer": "echo",
        "moves": "echoes_per_s", "workloads": ["echo-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", RUN_NEW_KIND, str(tmp_path), str(ROOT)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = [json.loads(x) for x in
                     out.stdout.strip().splitlines()[-2:]]
    for result in (plain, traced):
        assert result["correct"] is True
        assert result["checks"] == {"echo_gap": {"value": 0.0,
                                                 "limit": 0.0}}
    assert plain["metrics"]["echoes_per_s"]["value"] == 1.5
    assert set(plain["metrics"]) == {"echoes_per_s", "setup_s"}
    assert traced["metrics"] == {
        "echoes_per_s.echo": {"value": 1.5, "unit": "1/s"}}
    after = digest(pb)
    assert {k: v for k, v in after.items() if k in before} == before


def test_result_line_has_the_contract_keys(tmp_path):
    import pb_cells
    result = pb_cells.run(pb_cells.serve_cell())
    assert list(result)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in result
    assert result["correct"] is True, result["checks"]
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}


def test_card_path_refuses_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "serve-fused-closed", "--seed", str(2 ** 33), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_benchmark_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    names = set()
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    layers = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
        assert core.reader_path(m["name"]).is_file(), m["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    for w in BENCH["workloads"]:
        cell = core.load_cell(w["name"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.per_layer:
            assert any(e["name"] == m["moves"] for e in cell.end_to_end)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_trace_reduction_on_a_synthetic_trace():
    from portbench import tracing
    prof = tracing.Profile("cpu")
    prof.t0, prof.t1, prof.markers = 10.0, 10.010, [9.9999, 10.0102]

    def ev(ts, dur, name, cat="kernel"):
        return {"ph": "X", "cat": cat, "ts": ts, "dur": dur, "name": name}
    base = 5e6
    events = [ev(base + 9.9999e6, 1, "spin_kernel(long)"),
              ev(base + 10.000e6 + 1000, 2000, "gemm"),
              ev(base + 10.000e6 + 2500, 1000, "gemm"),
              ev(base + 10.000e6 + 6000, 1000, "Memcpy DtoH",
                 "gpu_memcpy"),
              ev(base + 10.0102e6, 1, "spin_kernel(long)")]
    spans = tracing.Spans()
    spans.records["audio.invert"].append((10.0035, 10.0058))
    s = tracing.summarize(events, prof, spans)
    assert abs(s["window_s"] - 0.010) < 1e-9
    assert abs(s["busy_s"] - 0.0035) < 1e-9
    assert s["kernels"]["gemm"][0] == 2
    gaps = dict(s["idle_gaps"])
    assert abs(gaps["audio.invert"] - 0.0025) < 1e-9
    assert abs(gaps[tracing.OUTSIDE] - 0.004) < 1e-9
    # without its markers the trace spans its first to last event
    s = tracing.summarize(events[1:4], prof, spans)
    assert abs(s["window_s"] - 0.006) < 1e-9
    assert abs(s["busy_s"] - 0.0035) < 1e-9
