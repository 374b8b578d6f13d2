"""Small cells for the CPU tests: the real configurations and mixes cut
to a few requests, steps and rows."""

import time

from portbench import core


def serve_cell(workload="serve-fused-closed", steps=4):
    cell = core.load_cell(workload)
    cell.config["serve"]["steps"] = steps
    cell.traffic.update(clients=2, buckets=[1, 2], preroll_s=0.3,
                        trace_s=0.5, trace_offset=0.1)
    cell.traffic["check"] = {"share": 1.0, "max": 4}
    return cell


def train_cell():
    cell = core.load_cell("train-ldm-b128")
    cell.config["model"]["image_size"] = 64
    cell.traffic.update(batch_size=4, trace_s=0.5, trace_offset=0.1,
                        corpus={"images": 40, "classes": 4, "pairs": 100})
    return cell


def run(cell, seconds=1.5, trace=False, seed=2 ** 33 + 7):
    return core.run_cell(cell, seed, seconds, trace, "cpu",
                         time.perf_counter())
