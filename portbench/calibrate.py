"""Readings behind the limits of ``correct``, on the card, at each cell's
own size (not run by the benchmark's runs):

    python3 portbench/calibrate.py --workload serve-fused-closed \
        --seeds 2147483659,2147483671 --seconds 4 --out readings.json

For each seed it runs the cell once (set-up, a short window, the check)
and keeps every compared number of the program; then, on the same checked
inputs, the cell's driver's ``control``: the reference in the precision
below the configuration's (the model's products in float8 e4m3, the
audio's in TF32) and, for training, the fault of a step that averages
over half of its batch.  A step that leaves the state unchanged reads 1
by the change measure and needs no run.  One process runs every seed, so only
the first builds the kernels.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    for group in [cell.traffic.get("limits", {})] + list(
            cell.config["limits"].values()):
        for k in group:
            group[k] = float("inf")
    dev = torch.device("cuda")
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = core.driver(cell.traffic).run(cell, seed, args.seconds, False,
                                            "cuda", t0)
        ctx = run["ctx"]
        row = {"seed": seed, "program": run["readings"],
               "failed": run["failed"], "attempted": run["attempted"],
               "setup_s": ctx["setup_s"], "window_s": ctx["window_s"],
               "peak_bytes": run["device"]["memory_peak_bytes"]}
        t1 = time.perf_counter()
        if run["sample"] is not None:
            row.update(core.driver(cell.traffic).control(
                cell, run["sample"], seed, dev))
        row["check_s"] = time.perf_counter() - t1
        rows.append(row)
        print(json.dumps(row), flush=True)
        del run
        torch.cuda.empty_cache()
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(),
           "rows": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
