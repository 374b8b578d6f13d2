"""The Riffusion serving driver: the engine of ``cli serve --model
riffusion-v1`` under a traffic mix.

Set-up makes the three models' weights on the card from the seed
(``reference/riffusion.py seeded_weights``, the program's names), loads
them in the served type into the program's ``Riffusion`` (channels-last),
and builds and warms ``InferenceEngine`` as ``cli serve`` does: the
configuration's SDEdit settings (the scan DDIM over
``transfer_time_grid(num_timesteps, sample_steps)`` with guidance), the
mix's buckets and ``max_wait_ms``, audio on; ``warmup`` runs every
bucket, the generate route and the audio's CUDA graph captures.

Requests pair a content image from a seeded pool of spectrogram images
with a prompt from a seeded pool of prompts (``prompt_tokens`` ids each,
uniform below BOS): the closed loop, the request plan and the window
are ``drivers/serve.py``'s (``Plan`` and ``drive``, imported), request
i's style index naming prompt ``i mod prompts``.  A traced run turns the
program's tracer on around the window (``program.on`` / ``off``), lays
its spans beside the harness's before the profile is reduced
(``program.merge``) and hands them to the readers as
``ctx["program"]``.

The check: the served image of each checked request against the
reference's float32 transfer of the same content, token ids and seed
(``image_gap``), and the served audio against the reference's inversion
of the served image (``audio_gap_median``).  ``control`` reads the same
numbers of the reference with its model products in float8 e4m3 and its
least-squares products in TF32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import compare, program, tracing
from portbench.drivers.serve import Plan, drive
from portbench.reference import riffusion as ref
from portbench.riffusion_cost import clip_flops
from portbench.state import device_info, image_pool, limits, release


def prompt_pool(mix: dict, text: dict, rng: np.random.Generator,
                rows: int) -> np.ndarray:
    """[rows, 77] token ids: ``prompts`` seeded prompts of
    ``prompt_tokens`` (low, high) ids, row i holding prompt i mod
    prompts."""
    lo, hi = mix["prompt_tokens"]
    prompts = [ref.prompt_ids(rng.integers(0, text["bos_id"], int(n)), text)
               for n in rng.integers(lo, hi + 1, mix["prompts"])]
    return np.stack([prompts[i % len(prompts)] for i in range(rows)])


def model_config(model: dict):
    """The program's ``RiffusionConfig`` of the configuration's model."""
    from music_style_transfer_ldm_tpu_torch.config import (
        RiffusionConfig, SDUNetConfig, TextEncoderConfig, VAEConfig,
    )

    def make(cls, d, **parts):
        names = {f.name for f in dataclasses.fields(cls)} - set(parts)
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in d.items() if k in names}, **parts)
    return make(RiffusionConfig, model,
                text=make(TextEncoderConfig, model["text"]),
                unet=make(SDUNetConfig, model["unet"]),
                vae=make(VAEConfig, model["vae"]))


def audio_config(audio: dict):
    from music_style_transfer_ldm_tpu_torch.config import (
        riffusion_audio_config,
    )
    keep = {f.name for f in dataclasses.fields(riffusion_audio_config())}
    return dataclasses.replace(riffusion_audio_config(), **{
        k: v for k, v in audio.items() if k in keep})


def make_model(cell, weights: dict, device):
    """The program's ``Riffusion`` with ``weights`` (strict loads), in
    the served type, channels-last, frozen, in eval mode."""
    from music_style_transfer_ldm_tpu_torch.models.riffusion import (
        Riffusion,
    )
    cfg = cell.config
    with torch.device("meta"):
        model = Riffusion(model_config(cfg["model"]),
                          audio_config(cfg["serve"]["audio"]))
    for part in ("text_encoder", "unet", "vae"):
        getattr(model, part).load_state_dict(weights[part], assign=True)
    model.requires_grad_(False)
    return model.to(device=device, dtype=getattr(torch, cfg["serve"]["dtype"]),
                    memory_format=torch.channels_last).eval()


def build_engine(cell, weights: dict, device):
    from music_style_transfer_ldm_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine,
    )
    sv, mix = cell.config["serve"], cell.traffic
    ecfg = EngineConfig(steps=sv["num_timesteps"], eta=sv["eta"],
                        sampler=sv["sampler"],
                        sample_steps=sv["sample_steps"],
                        guidance=sv["guidance"],
                        generate_guidance=sv["guidance"],
                        batch_buckets=tuple(mix["buckets"]),
                        max_wait_ms=mix["max_wait_ms"],
                        griffin_lim_iters=sv["audio"]["griffin_lim_iters"],
                        nnls_iters=sv["audio"]["nnls_iters"],
                        invert_audio=True)
    return InferenceEngine(make_model(cell, weights, device), ecfg)


def instrument(engine, spans: tracing.Spans, device,
               profile: tracing.Profile):
    """The harness's spans of a traced run (the model's transfer and
    inversion, each ended by a synchronise, and the engine's
    ``transfer_batch``); the dispatch thread opens and closes the profile
    between two batches.  Returns the undo."""
    model = engine.ldm
    model.transfer = spans.wrap("ldm.sampler", model.transfer, device)
    model.invert = spans.wrap("audio.invert", model.invert, device)
    batch = spans.wrap("engine.transfer_batch", engine.transfer_batch)

    def transfer_batch(*args, **kwargs):
        profile.tick()
        return batch(*args, **kwargs)
    engine.transfer_batch = transfer_batch

    def undo():
        del model.transfer, model.invert, engine.transfer_batch
    return undo


def reference_weights(weights: dict, cfg: dict) -> dict:
    """The served weights (rounded to the served type) in float32."""
    dt = getattr(torch, cfg["serve"]["dtype"])
    return {part: {k: v.to(dt).float() for k, v in w.items()}
            for part, w in weights.items()}


def gaps(P, cfg, content, prompts, reqs, imgs, auds, device,
         prec: ref.Precision = ref.F32, audio_tf32: bool = False,
         block: int = 2) -> dict:
    """Gaps of images and audio from the reference, ``block`` clips at a
    time: with the float32 reference, the served ones (``imgs``,
    ``auds``: the program's); with the control (``prec``), the control's
    own against the float32 reference."""
    sv = cfg["serve"]
    per = []
    for s in range(0, len(reqs), block):
        part = reqs[s:s + block]
        c = torch.as_tensor(content[[r[0] for r in part], ..., 0],
                            device=device)
        ids = torch.as_tensor(prompts[[r[1] for r in part]], device=device)
        seeds = [r[2] for r in part]
        want = ref.transfer(P, c, ids, seeds, cfg["model"], sv)
        if imgs is None:
            img = ref.transfer(P, c, ids, seeds, cfg["model"], sv, prec)
            aud = ref.image_to_audio(img, cfg["serve"]["audio"], audio_tf32)
        else:
            img = torch.as_tensor(imgs[s:s + block], device=device)
            aud = torch.as_tensor(auds[s:s + block], device=device)
        per.append(compare.clip_gaps(
            img, want, aud, ref.image_to_audio(img, cfg["serve"]["audio"])))
    return compare.serve_gaps(per)


def check(cell, weights, pool, plan: Plan, kept: dict, seed: int, device):
    mix, cfg = cell.traffic, cell.config
    ids = sorted(kept)
    rng = np.random.default_rng([seed, 3])
    n = min(len(ids), mix["check"]["max"])
    ids = sorted(rng.choice(ids, n, replace=False).tolist()) if n else []
    lim = limits(cell)
    if not ids:
        return {k: {"value": float("inf"), "limit": v}
                for k, v in lim.items()}, {}, None
    P = reference_weights(weights, cfg)
    content, prompts = pool
    reqs = [plan[i] for i in ids]
    imgs = np.stack([kept[i]["image"][..., 0] for i in ids])
    auds = np.stack([kept[i]["audio"] for i in ids])
    readings = gaps(P, cfg, content, prompts, reqs, imgs, auds, device)
    checks = {k: {"value": readings[k], "limit": v} for k, v in lim.items()}
    return checks, readings, {"P": P, "pool": pool, "reqs": reqs}


def control(cell, smp: dict, seed: int, device) -> dict:
    """The compared numbers of the control on the run's checked inputs:
    the reference's transfer with the model's products in float8 e4m3,
    and its inversion with the least-squares products in TF32."""
    content, prompts = smp["pool"]
    return {"control": gaps(smp["P"], cell.config, content, prompts,
                            smp["reqs"], None, None, device,
                            ref.Precision("fp8"), audio_tf32=True)}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> dict:
    from music_style_transfer_ldm_tpu_torch.models import (  # noqa: F401
        riffusion,   # the program's model: a program without it stops here
    )
    mix, cfg = cell.traffic, cell.config
    dev = torch.device(device)
    weights = ref.seeded_weights(cfg["model"], seed, dev)
    engine = build_engine(cell, weights, dev)
    rng = np.random.default_rng([seed, 0])
    size = cfg["model"]["image_size"]
    pool = (image_pool(mix["pool"], size, rng),
            prompt_pool(mix, cfg["model"]["text"], rng, mix["pool"]))
    plan = Plan(seed, mix["pool"], mix["check"]["share"])
    spans = tracing.Spans() if trace else None
    profile = tracing.Profile(dev) if trace else None
    if profile is not None:
        profile.prime()
    engine.warmup()
    undo = instrument(engine, spans, dev, profile) if trace else None
    tracer = program.on(trace)
    engine.start()
    try:
        rec = drive(engine, pool, plan, mix, seconds, profile)
    finally:
        engine.stop()
        recorded = program.off(tracer, dev)
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
        program.merge(spans, recorded)
        summary = profile.reduce(spans)
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    checks, readings, sample = check(cell, weights, pool, plan, rec["kept"],
                                     seed, dev)
    done = rec["done"]
    ctx = {"cell": cell, "kind": "serve", "setup_s": w0 - t0,
           "window_s": w1 - w0, "completed": sum(not d[3] for d in done),
           "latencies_s": [d[2] - d[1] for d in done if not d[3] and
                           tracing.outside(d[1], d[2], spans and
                                           spans.exclude)],
           "spans": spans, "trace": summary, "stats": stats,
           "device_kind": info["kind"]}
    if recorded is not None:
        ctx["program"] = dict(recorded, window=(w0, w1),
                              exclude=spans.exclude)
    if trace:
        ctx["work"] = {"clip_flops": clip_flops(
            sample["P"] if sample else reference_weights(weights, cfg),
            cfg["model"], cfg["serve"], cfg["serve"]["audio"], dev)}
    out = {"attempted": len(done), "failed": rec["failed"], "ctx": ctx,
           "device": info, "checks": checks, "readings": readings,
           "sample": sample}
    if summary:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out
