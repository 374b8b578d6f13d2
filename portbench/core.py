"""The harness: one cell, once.

``run.py --workload W --seed N --seconds S --trace 0|1`` finds the cell
``W`` in ``BENCHMARK.json``, its configuration file (``configs[].file``)
and its traffic mix (``portbench/traffic/<traffic>.json``), and hands
them to the driver the mix names: ``kind`` in the mix is a module of
``portbench/drivers/`` (``serve``, ``train_ldm``).  The driver builds
the program under test from the seed, warms every shape the mix uses,
measures for S seconds, and checks what the timed path produced against
the plain reference (``portbench/reference/``), holding each compared
number to the limits of the mix (``limits``) or, failing those, of the
configuration's group named by the kind (``limits.<kind>``).

Every metric is read by a file of its own in ``portbench/metrics/``
(``read(ctx) -> float | None``): ``<name>.py``, or, where there is none,
the file of the name without its last dot-separated parts, so that
``engine.batch_ms.fused`` and ``engine.batch_ms.b128`` share
``engine.batch_ms.py``.  With ``--trace 0`` the cell's end-to-end
metrics are read, with ``--trace 1`` its per-layer ones.  A reader that
finds nothing returns None and the metric is left out of the line.  So a
later cell, mix, configuration, driver or metric is a new file and a new
entry, and no file here changes.

The last line on standard output is the result; the numbers compared
for ``correct`` are the last lines on standard error and the last key
of the result.  Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded once the window has
closed, the run prints no result and exits with a code other than 0.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "music_style_transfer_ldm_tpu")


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, bench_path: Optional[Path] = None,
              base: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``bench_path`` (default: the checkout's
    BENCHMARK.json); files are looked up under ``base`` (the checkout)."""
    base = base or ROOT
    bench = json.loads((bench_path or base / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((base / configs[w["config"]]["file"]).read_text())
    traffic_dir = base / bench["paths"][0] / "traffic"
    traffic = json.loads((traffic_dir / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def reader_path(name: str, base: Optional[Path] = None) -> Path:
    """``<base>/metrics/<name>.py``, else that of the longest leading part
    of ``name`` (cut at its dots) that has a file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = (base or HERE) / "metrics" / (".".join(parts[:n]) + ".py")
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r}")


def reader(name: str, base: Optional[Path] = None) -> Callable:
    """``read`` of the metric's reader file."""
    path = reader_path(name, base)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(traffic: dict):
    """The module ``portbench/drivers/<kind>.py`` of the mix's ``kind``:
    ``run(cell, seed, seconds, trace, device, t0)`` and, for the
    readings behind the limits, ``control(cell, sample, seed, device)``."""
    kind = traffic["kind"]
    if not kind.isidentifier():
        raise ValueError(f"traffic kind {kind!r} names no driver module")
    return importlib.import_module(f"portbench.drivers.{kind}")


def read_metrics(metrics: List[dict], ctx: dict,
                 base: Optional[Path] = None) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"], base)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t0: float, metrics_base: Optional[Path] = None
             ) -> dict:
    """Run the cell once on ``device`` and return the result object
    (``checks`` last).  The card path (``main``) calls this with
    ``device='cuda'``; tests call it on the CPU at small sizes."""
    run = driver(cell.traffic).run(cell, seed, seconds, trace, device, t0)
    ctx = run["ctx"]
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           ctx, metrics_base)
    checks = run["checks"]
    correct = (run["failed"] == 0 and bool(checks) and all(
        c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics,
              "device": run["device"]}
    if trace and run.get("breakdown"):
        result["breakdown"] = run["breakdown"]
    result["checks"] = checks
    return result


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict) -> None:
    """The compared numbers as the last lines on standard error, then
    the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 3
    emit(result)
    return 0
