"""The serving driver: the engine of ``cli serve`` under a traffic mix.

Set-up makes the model's weights on the device from the seed (the
reference's names, ``reference/weights.py``) and loads them, in the
served type, into the program's ``LDM``; builds ``InferenceEngine`` as
``cli serve`` builds it (the configuration's sampler, steps and eta; the
mix's buckets and ``max_wait_ms``; audio on) and warms it
(``InferenceEngine.warmup``: every bucket).  Requests are content/style
pairs from a pool made from the seed, each with its own request seed;
request i's pair and seed are fixed by (seed, i) whatever the timing.

Arrivals: a closed loop (``loop`` in the mix is ``closed``, the one
kind this driver offers) of ``clients`` callers, each sending its next
request as soon as its reply arrives.  One collector (this thread) takes
replies in submission order, which is the engine's order (one FIFO
queue, one dispatch thread).  After ``preroll_s`` the window opens; it
lasts ``seconds``; a reply counts if it arrives inside it.  Latency is
submit to reply.  Then the loop stops sending, the rest drain, the
engine stops and its model is freed.

The check: a share of requests (``check.share``, drawn from the seed
before the run) keep their replies; up to ``check.max`` of those answered
inside the window are compared with the reference: the image with the
reference's transfer of the same inputs in float32, and the audio with
the reference's inversion of the served image (the image is the
program's output; the inversion is judged on it).  ``control`` reads
the same numbers of the reference put in the program's place one
precision below the configuration's (``calibrate.py``).
"""

from __future__ import annotations

import collections
import queue
import time

import numpy as np
import torch

from portbench import compare, tracing
from portbench.reference import audio as ref_audio
from portbench.reference import nets
from portbench.reference import sample as ref_sample
from portbench.reference import weights as ref_weights
from portbench.state import (
    device_info, image_pool, limits as cell_limits, make_ldm, release,
)


class Plan:
    """Request i's (content index, style index, seed, checked) from the
    run's seed; the plan wraps after ``n`` requests."""

    def __init__(self, seed: int, pool: int, share: float, n: int = 1 << 18):
        rng = np.random.default_rng([seed, 1])
        self.content = rng.integers(0, pool, n)
        self.style = rng.integers(0, pool, n)
        self.seeds = rng.integers(0, 2 ** 31 - 1, n)
        self.checked = rng.random(n) < share
        self.n = n

    def __getitem__(self, i: int):
        j = i % self.n
        return (int(self.content[j]), int(self.style[j]),
                int(self.seeds[j]), bool(self.checked[j]))


def build_engine(cell, weights: dict, device: str):
    from music_style_transfer_ldm_tpu_torch.config import AudioConfig
    from music_style_transfer_ldm_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine,
    )
    cfg, mix = cell.config, cell.traffic
    sv = cfg["serve"]
    ldm = make_ldm(cfg["model"], weights, getattr(torch, sv["dtype"]),
                   device)
    au = sv["audio"]
    ecfg = EngineConfig(steps=sv["steps"], eta=sv["eta"],
                        sampler=sv["sampler"],
                        batch_buckets=tuple(mix["buckets"]),
                        max_wait_ms=mix["max_wait_ms"],
                        image_size=cfg["model"]["image_size"],
                        griffin_lim_iters=au["griffin_lim_iters"],
                        nnls_iters=au["nnls_iters"], invert_audio=True)
    audio = AudioConfig(sample_rate=au["sample_rate"], n_fft=au["n_fft"],
                        hop_length=au["hop_length"],
                        win_length=au["n_fft"])
    return InferenceEngine(ldm, ecfg, audio=audio)


def instrument(engine, spans: tracing.Spans, device,
               profile: tracing.Profile):
    """Wrap the engine's layer boundaries for a traced run; the engine's
    dispatch thread, the one thread that launches work on the card, opens
    and closes the profile between two batches.  Returns the undo."""
    from music_style_transfer_ldm_tpu_torch.serving import engine as mod
    saved = {k: getattr(mod, k) for k in (
        "fused_content_style_transfer", "transfer_decoded", "mel_to_audio")}
    mod.fused_content_style_transfer = spans.wrap(
        "ldm.sampler", saved["fused_content_style_transfer"], device)
    mod.transfer_decoded = spans.wrap("ldm.sampler",
                                      saved["transfer_decoded"], device)
    mod.mel_to_audio = spans.wrap("audio.invert", saved["mel_to_audio"],
                                  device)
    batch = spans.wrap("engine.transfer_batch", engine.transfer_batch)

    def transfer_batch(*args, **kwargs):
        profile.tick()
        return batch(*args, **kwargs)
    engine.transfer_batch = transfer_batch

    def undo():
        for k, v in saved.items():
            setattr(mod, k, v)
        del engine.transfer_batch
    return undo


def drive(engine, pool, plan: Plan, mix: dict, seconds: float,
          profile=None):
    """Run the closed loop; returns the window's records."""
    if mix["loop"] != "closed":
        raise ValueError(f"loop {mix['loop']!r}: this driver runs closed "
                         "loops only")
    content, style = pool
    outstanding = collections.deque()   # (id, t_sent, reply queue)
    state = {"next": 0}

    def send():
        i = state["next"]
        state["next"] += 1
        c, s, rs, _ = plan[i]
        q = engine.submit(content[c], style[s], seed=rs)
        outstanding.append((i, time.perf_counter(), q))

    t_begin = time.perf_counter()
    w0 = t_begin + mix["preroll_s"]
    w1 = w0 + seconds
    if profile is not None:
        # it closes on the first batch after ``until``; the drain after
        # the window always dispatches one
        at = w0 + mix.get("trace_offset", 0.3) * seconds
        profile.schedule(at, min(mix.get("trace_s", 2.0), w1 - at))
    done, kept, failed = [], {}, 0
    for _ in range(mix["clients"]):
        send()
    stopping = False
    while outstanding:
        if time.perf_counter() >= w1:
            stopping = True
        i, t_sent, q = outstanding[0]
        try:
            out = q.get(timeout=0.05)
        except queue.Empty:
            continue
        outstanding.popleft()
        t_done = time.perf_counter()
        err = isinstance(out, Exception)
        if w0 <= t_done < w1:
            done.append((i, t_sent, t_done, err))
            failed += err
            if plan[i][3] and not err:
                kept[i] = out
        if not stopping:
            send()
    return {"window": (w0, w1), "done": done, "kept": kept,
            "failed": failed, "sent": state["next"]}


def check(cell, weights: dict, pool, plan: Plan, kept: dict, seed: int,
          device) -> dict:
    """The compared numbers over a seeded sample of the requests that
    were answered inside the window."""
    mix, cfg = cell.traffic, cell.config
    ids = sorted(kept)
    rng = np.random.default_rng([seed, 3])
    n = min(len(ids), mix["check"]["max"])
    ids = sorted(rng.choice(ids, n, replace=False).tolist()) if n else []
    limits = cell_limits(cell)
    if not ids:
        return {k: {"value": float("inf"), "limit": v}
                for k, v in limits.items()}, {}, None
    P = reference_weights(weights, cfg)
    content, style = pool
    reqs = [plan[i] for i in ids]
    imgs = np.stack([kept[i]["image"][..., 0] for i in ids])
    auds = np.stack([kept[i]["audio"] for i in ids])
    readings = reference_readings(P, cfg, content, style, reqs, imgs, auds,
                                  device)
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in limits.items()}
    return checks, readings, {"P": P, "pool": pool, "reqs": reqs}


def reference_weights(weights: dict, cfg: dict) -> dict:
    """The served weights (rounded to the served type) in float32."""
    dt = getattr(torch, cfg["serve"]["dtype"])
    return {k: (v.to(dt).float() if v.is_floating_point() else v)
            for k, v in weights.items()}


def reference_readings(P, cfg, content, style, reqs, imgs, auds, device,
                       block: int = 64) -> dict:
    """Gaps of served images and audio from the reference, in blocks."""
    sv = cfg["serve"]
    audio = dict(sv["audio"], seconds=3.0)
    gaps = []
    for s in range(0, len(reqs), block):
        part = reqs[s:s + block]
        c = torch.as_tensor(content[[r[0] for r in part], ..., 0],
                            device=device)
        st = torch.as_tensor(style[[r[1] for r in part], ..., 0],
                             device=device)
        ref_img = ref_sample.transfer(P, c, st, [r[2] for r in part],
                                      cfg["model"], sv["steps"])
        served = torch.as_tensor(imgs[s:s + block], device=device)
        ref_aud = ref_audio.image_to_audio(served, audio)
        gaps.append(compare.clip_gaps(
            served, ref_img, torch.as_tensor(auds[s:s + block],
                                             device=device), ref_aud))
    return compare.serve_gaps(gaps)


def control(cell, smp: dict, seed: int, device) -> dict:
    """The compared numbers of the control on the run's checked inputs:
    the reference's transfer with the model's products in float8 e4m3,
    and its inversion with the least-squares products in TF32."""
    cfg = cell.config
    content, style = smp["pool"]
    reqs = smp["reqs"]
    audio = dict(cfg["serve"]["audio"], seconds=3.0)
    fp8 = nets.Precision("fp8")
    gaps = []
    for s in range(0, len(reqs), 64):
        part = reqs[s:s + 64]
        c = torch.as_tensor(content[[r[0] for r in part], ..., 0],
                            device=device)
        st = torch.as_tensor(style[[r[1] for r in part], ..., 0],
                             device=device)
        seeds = [r[2] for r in part]
        ref = ref_sample.transfer(smp["P"], c, st, seeds, cfg["model"],
                                  cfg["serve"]["steps"])
        ctrl = ref_sample.transfer(smp["P"], c, st, seeds, cfg["model"],
                                   cfg["serve"]["steps"], fp8)
        aud = ref_audio.image_to_audio(ctrl, audio, matmul_tf32=True)
        gaps.append(compare.clip_gaps(
            ctrl, ref, aud, ref_audio.image_to_audio(ctrl, audio)))
    return {"control": compare.serve_gaps(gaps)}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> dict:
    mix = cell.traffic
    dev = torch.device(device)
    weights = ref_weights.seeded_weights(cell.config["model"], seed, dev)
    engine = build_engine(cell, weights["ldm"], device)
    rng = np.random.default_rng([seed, 0])
    size = cell.config["model"]["image_size"]
    pool = (image_pool(mix["pool"], size, rng),
            image_pool(mix["pool"], size, rng))
    plan = Plan(seed, mix["pool"], mix["check"]["share"])
    spans = tracing.Spans() if trace else None
    profile = tracing.Profile(dev) if trace else None
    if profile is not None:
        profile.prime()
    engine.warmup()
    undo = instrument(engine, spans, dev, profile) if trace else None
    engine.start()
    try:
        rec = drive(engine, pool, plan, mix, seconds, profile)
    finally:
        engine.stop()
        if undo is not None:
            undo()
    w0, w1 = rec["window"]
    info = device_info(dev, cell.chips)
    stats = engine.stats()
    del engine
    release(dev)
    summary = None
    if profile is not None and profile.t1 is not None:
        spans.exclude = (profile.t0, profile.closed)
        summary = profile.reduce(spans)
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    checks, readings, sample = check(cell, weights["ldm"], pool, plan,
                                     rec["kept"], seed, dev)
    done = rec["done"]
    ctx = {"cell": cell, "kind": "serve", "setup_s": w0 - t0,
           "window_s": w1 - w0, "completed": sum(not d[3] for d in done),
           "latencies_s": [d[2] - d[1] for d in done if not d[3] and
                           tracing.outside(d[1], d[2], spans and
                                           spans.exclude)],
           "spans": spans, "trace": summary, "stats": stats,
           "device_kind": info["kind"]}
    if trace:
        ctx["work"] = {"clip_flops": compare.clip_flops(
            reference_weights(weights["ldm"], cell.config), cell.config,
            dev)}
    out = {"attempted": len(done), "failed": rec["failed"], "ctx": ctx,
           "device": info, "checks": checks, "readings": readings,
           "sample": sample}
    if summary:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out
