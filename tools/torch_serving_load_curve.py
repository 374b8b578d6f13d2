#!/usr/bin/env python3
"""Serving latency and throughput under Poisson load, on the port's engine.

The port's counterpart of ``tools/serving_load_curve.py``: open-loop
Poisson arrivals at each offered rate into
``serving.engine.InferenceEngine`` (the flagship LDM, bf16, random
weights from seed 0), with bucket autoscaling off and then on; for each
rate the p50/p90/p99/max latency and the achieved clips/s, under the JAX
record's keys.  Open loop: arrivals do not wait for completions, and a
request's latency runs from its scheduled arrival time, so queueing
shows once the engine saturates.

One collector thread takes the completions, in submission order (the
engine's one dispatch thread answers requests in the order they were
queued), so the load generator adds no thread per request beside the
engine's dispatch thread, which shares the interpreter with it.  A
request still unanswered ``DRAIN_S`` seconds after the level's last
arrival is not counted as completed and is reported on stderr.

``--sampler dpm++`` (the default, 26 grid points) takes the scan route
(kernel B each DDIM-family step); ``--sampler fused-dpm++`` takes kernel
A on buckets up to ``utils/chips.py fused_bucket_max()`` and the scan
route above.  ``--autoscale off|on|both`` (default both, as the JAX tool
runs) picks the runs.

    python tools/torch_serving_load_curve.py \
        [--loads 50,100,200,400,800,1600] [--seconds 8] [--invert-audio] \
        [--sampler dpm++|fused-dpm++] \
        [--out runs/torch/serving_load_curve.json]
    python tools/torch_serving_load_curve.py --device cpu --loads 4 \
        --seconds 1 --steps 2 --sample-steps 2 --buckets 1,2

The record adds ``power_limit`` (``nvidia-smi``'s name and power limit)
to the JAX keys; stderr ends with the kernels' launch line.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.torch_common import (  # noqa: E402
    REPO, add_device_arg, chip_name, device_of, power_limit, print_launches,
)

# Keys this record has beyond the JAX tool's.
EXTRA_KEYS = ("power_limit",)
# Seconds after a level's last arrival that its requests may still take.
DRAIN_S = 300.0


def summarize_level(rate_per_s: float, n_sent: int, results: list,
                    t0: float, t_sent_end: float, t_end: float) -> dict:
    """One level's record from its (scheduled arrival, completion, error)
    triples, with the JAX tool's formulas."""
    lats = sorted((d - s) * 1000 for s, d, err in results if not err)
    errors = sum(1 for _, _, err in results if err)
    done = len(lats)
    return {
        "offered_clips_per_s": round(rate_per_s, 1),
        "sent": n_sent,
        "completed": done,
        "errors": errors,
        "achieved_clips_per_s": round(done / max(t_end - t0, 1e-9), 1),
        "p50_ms": round(lats[done // 2], 1) if done else None,
        "p90_ms": round(lats[int(done * 0.9)], 1) if done else None,
        "p99_ms": round(lats[min(int(done * 0.99), done - 1)], 1)
        if done else None,
        "max_ms": round(lats[-1], 1) if done else None,
        "drain_s": round(t_end - t_sent_end, 2),
    }


def drive_level(engine, rate_per_s: float, seconds: float,
                content: np.ndarray, style: np.ndarray, rng,
                drain_s: float = DRAIN_S) -> dict:
    """Open-loop Poisson arrivals at rate_per_s for ``seconds``; returns
    the level's latency percentiles and achieved throughput."""
    results = []                  # (scheduled arrival, done, error)
    sent: queue.Queue = queue.Queue()   # (done queue, scheduled arrival)
    stop_at = [float("inf")]

    def collect():
        while True:
            item = sent.get()
            if item is None:
                return
            done_q, t_sched = item
            while True:
                try:
                    out = done_q.get(timeout=0.05)
                    break
                except queue.Empty:
                    if time.monotonic() > stop_at[0]:
                        return
            results.append((t_sched, time.monotonic(),
                            isinstance(out, Exception)))

    collector = threading.Thread(target=collect, daemon=True)
    collector.start()
    t0 = time.monotonic()
    n_sent = 0
    next_t = t0
    while True:
        now = time.monotonic()
        if now - t0 >= seconds:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.002))
            continue
        i = n_sent % len(content)
        sent.put((engine.submit(content[i], style[i], seed=n_sent), next_t))
        n_sent += 1
        next_t += rng.exponential(1.0 / rate_per_s)
    t_sent_end = time.monotonic()
    stop_at[0] = t_sent_end + drain_s
    sent.put(None)
    collector.join()
    t_end = time.monotonic()
    unfinished = n_sent - len(results)
    if unfinished:
        print(f"rate {rate_per_s}: {unfinished} of {n_sent} requests "
              f"unanswered {drain_s:.0f} s after the last arrival (not "
              "completed)", file=sys.stderr, flush=True)
    return summarize_level(rate_per_s, n_sent, results, t0, t_sent_end,
                           t_end)


def run_curve(autoscale: bool, loads, seconds: float, invert_audio: bool,
              sampler: str, sample_steps, steps: int = 50,
              buckets=(1, 2, 4, 8), device="cuda") -> dict:
    import torch

    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine,
    )

    cfg = default_config()
    ldm = build_ldm(cfg, dtype=torch.bfloat16, device=device, seed=0)
    S = cfg.model.image_size
    ecfg = EngineConfig(steps=steps, sampler=sampler,
                        sample_steps=sample_steps,
                        invert_audio=invert_audio, autoscale=autoscale,
                        batch_buckets=tuple(buckets), max_bucket=128)
    engine = InferenceEngine(ldm, ecfg)
    t0 = time.time()
    engine.warmup()
    warm_s = time.time() - t0
    engine.start()

    rng = np.random.RandomState(0)
    content = rng.rand(16, S, S, 1).astype(np.float32)
    style = rng.rand(16, S, S, 1).astype(np.float32)
    # Prime: one request through the full path before timing.
    primed = engine.submit(content[0], style[0], seed=0).get()
    if isinstance(primed, Exception):
        raise primed

    levels = []
    try:
        for rate in loads:
            lv = drive_level(engine, rate, seconds, content, style, rng)
            lv["stats"] = dict(engine.stats())
            levels.append(lv)
            print(f"autoscale={autoscale} rate={rate}: {lv}", flush=True)
    finally:
        engine.stop()
    return {"autoscale": autoscale, "warmup_s": round(warm_s, 1),
            "levels": levels, "engine_stats": dict(engine.stats())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--loads", default="50,100,200,400,800,1600")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--invert-audio", action="store_true",
                   help="full product path incl. NNLS+Griffin-Lim audio "
                        "(default: mel-image serving)")
    p.add_argument("--sampler", default="dpm++")
    p.add_argument("--sample-steps", type=int, default=26)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--buckets", default="1,2,4,8")
    p.add_argument("--autoscale", choices=["off", "on", "both"],
                   default="both",
                   help="the runs: autoscaling off, on, or both in turn")
    p.add_argument("--out", default=str(REPO / "runs" / "torch"
                                        / "serving_load_curve.json"))
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    loads = [float(x) for x in args.loads.split(",")]
    buckets = [int(b) for b in args.buckets.split(",")]
    modes = {"off": [False], "on": [True], "both": [False, True]}
    record = {
        "chip": chip_name(dev),
        "power_limit": power_limit(dev),
        "backend": dev.type,
        "sampler": args.sampler, "sample_steps": args.sample_steps,
        "invert_audio": bool(args.invert_audio),
        "seconds_per_level": args.seconds,
        "arrivals": "open-loop Poisson (exponential inter-arrival)",
        "runs": [run_curve(a, loads, args.seconds, args.invert_audio,
                           args.sampler, args.sample_steps, args.steps,
                           buckets, dev) for a in modes[args.autoscale]],
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {out}", flush=True)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
