"""The autoencoder driver: ``AETrainer``'s step as ``cli train --model
autoencoder`` runs phase 1, fed by a card-resident corpus.

Set-up is ``train_ldm.py``'s (its helpers, imported): a seeded corpus at
the reference's scale written as a pack and a pairings CSV under TMPDIR,
loaded onto the card as uint8 (``DeviceResidentPairs``) and walked by
``DevicePairLoader`` (shuffled from the seed, whole batches); the step
takes each pair's content image.  The trainer is built with the mix's
settings (B=128, float32 with TF32 off, MSE + 0.1 LPIPS + 0.01 KL,
AdamW at 5e-4, weight decay 0.01), the benchmark's weights go into its
encoder, decoder and LPIPS trunk, and the first ``check_steps`` steps
run through the same call and feed as the window.  Then the window runs
step after step for ``seconds`` and ends after a synchronise.

The check rebuilds the checked batches from the corpus and the loader's
seed, runs the reference's steps (``reference/train_ae.py``) from the
same weights, and reads ``gaps``: ``compare.train_gaps`` and the first
step's gradient by the norm of each leaf's difference.  The mix's own
limits name the numbers compared.  ``control`` reads the same numbers of
the reference with its products in TF32, one precision below the
float32 the cell runs, and of steps that average over half of each
batch.
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import compare, tracing
from portbench.drivers.train_ldm import (
    Feed, first_grads, make_corpus, reference_batch, snapshot, write_corpus,
)
from portbench.reference import train_ae as ref_ae
from portbench.reference import weights as ref_weights
from portbench.state import device_info, limits, release


def gaps(prog: dict, ref: dict, theta0: dict) -> dict:
    """``compare.train_gaps``, and ``grad_diff``: the first step's
    gradient, per leaf ||g - g_ref|| / max(||g_ref||, median ||g_ref||),
    the worst leaf, and ``grad_diff_median`` the median leaf
    (``train_gaps``' ``grad_gap`` compares the two leaves' norms alone,
    which a rounding of the products hardly moves)."""
    out = compare.train_gaps(prog, ref, theta0)
    g, r = prog["first_grads"], ref["first_grads"]
    rn = torch.stack([r[k].float().norm() for k in r])
    floor = torch.maximum(rn, rn.median()).clamp(min=1e-30)
    diff = torch.stack([(g[k].float() - r[k].float()).norm() for k in r])
    leaf = (diff / floor).cpu()
    out["grad_diff"] = float(leaf.max())
    out["grad_diff_median"] = float(leaf.median())
    return out


def trainer_config(cell, seed: int):
    from music_style_transfer_ldm_tpu_torch.config import default_config
    cfg = default_config()
    m, t = cell.config["model"], cell.traffic["train"]
    cfg.model.latent_dim = m["latent_dim"]
    cfg.model.image_size = m["image_size"]
    tr = cfg.train
    tr.batch_size = cell.traffic["batch_size"]
    tr.learning_rate = t["learning_rate"]
    tr.perceptual_weight = t["perceptual_weight"]
    tr.kl_weight = t["kl_weight"]
    tr.compression_feature_extractor = t["compression_feature_extractor"]
    tr.seed = int(seed)
    return cfg


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> dict:
    from music_style_transfer_ldm_tpu_torch.datasets.device import (
        DevicePairLoader, DeviceResidentPairs,
    )
    from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (
        AETrainer,
    )
    mix, model = cell.traffic, cell.config["model"]
    dev = torch.device(device)
    rng = np.random.default_rng([seed, 0])
    corpus = make_corpus(mix["corpus"], model["image_size"], rng)
    folder = tempfile.mkdtemp(prefix="portbench-")
    try:
        pack, table = write_corpus(folder, corpus)
        dataset = DeviceResidentPairs(pack, table, crop=model["image_size"],
                                      device=dev)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    loader_seed = int(rng.integers(0, 2 ** 31 - 1))
    loader = DevicePairLoader(dataset, mix["batch_size"], shuffle=True,
                              seed=loader_seed, drop_last=True)
    weights = ref_weights.seeded_weights(model, seed, dev, trunks=True)
    trainer = AETrainer(trainer_config(cell, seed), device=dev,
                        feature_params=weights["lpips"])
    state = trainer.init_state(seed=0)
    state.model.load_state_dict({
        k: v for k, v in weights["ldm"].items()
        if k.startswith(("encoder.", "decoder."))})
    names = [k for k, _ in state.model.named_parameters()]
    theta0 = snapshot(state, names)
    feed = Feed(loader)
    losses, grads = [], None
    for i in range(mix["check_steps"]):
        content, _ = feed()
        state, loss = trainer._step(state, content)
        losses.append(float(loss))
        if i == 0:
            grads = first_grads(state, names)
    prog = {"losses": losses, "first_grads": grads,
            "params": snapshot(state, names)}
    spans = tracing.Spans() if trace else None
    if trace:
        feed = spans.wrap("data.next_batch", feed)
    profile = tracing.Profile(dev) if trace else None
    step = spans.wrap("train.step", trainer._step) if trace else trainer._step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    w0 = time.perf_counter()
    if profile is not None:
        profile.schedule(w0 + mix.get("trace_offset", 0.3) * seconds,
                         min(mix.get("trace_s", 2.0), 0.5 * seconds))
    steps = 0
    while time.perf_counter() - w0 < seconds:
        if profile is not None:
            profile.tick()
        content, _ = feed()
        state, _ = step(state, content)
        steps += 1
    if profile is not None and profile.t0 is not None and profile.t1 is None:
        profile.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    w1 = time.perf_counter()
    info = device_info(dev, cell.chips)
    del state, trainer, loader, dataset, feed, step
    release(dev)
    summary = None
    if profile is not None and profile.t1 is not None:
        spans.exclude = (profile.t0, profile.closed)
        summary = profile.reduce(spans)
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    checks, readings, sample = check(cell, weights, corpus, loader_seed,
                                     prog, theta0, dev)
    ctx = {"cell": cell, "kind": "train", "setup_s": w0 - t0,
           "window_s": w1 - w0, "steps": steps,
           "samples": steps * mix["batch_size"], "spans": spans,
           "trace": summary, "device_kind": info["kind"]}
    out = {"attempted": steps, "failed": 0, "ctx": ctx, "device": info,
           "checks": checks, "readings": readings, "sample": sample}
    if summary:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out


def check(cell, weights, corpus, loader_seed: int, prog: dict,
          theta0: dict, dev):
    mix = cell.traffic
    B = mix["batch_size"]
    order = np.random.RandomState(loader_seed).permutation(len(corpus[3]))
    batches = [reference_batch(corpus, order[i * B:(i + 1) * B], dev)[0]
               for i in range(mix["check_steps"])]
    ref = ref_ae.ae_steps(weights["ldm"], weights["lpips"], batches,
                          mix["train"])
    readings = gaps(prog, ref, theta0)
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in limits(cell).items()}
    sample = {"weights": weights, "batches": batches, "theta0": theta0,
              "ref": ref}
    return checks, readings, sample


def control(cell, smp: dict, seed: int, device=None) -> dict:
    """The numbers of the control (the reference's steps with the
    products in TF32: ``reference/train_ae.py TF32``) and of steps over
    half of each checked batch, against the reference's steps."""
    train = cell.traffic["train"]
    w = smp["weights"]
    ctrl = ref_ae.ae_steps(w["ldm"], w["lpips"], smp["batches"], train,
                           ref_ae.TF32)
    halved = ref_ae.ae_steps(w["ldm"], w["lpips"],
                             [x[:x.shape[0] // 2] for x in smp["batches"]],
                             train)
    return {"control": gaps(ctrl, smp["ref"], smp["theta0"]),
            "half_batch": gaps(halved, smp["ref"], smp["theta0"])}
