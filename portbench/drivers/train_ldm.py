"""The training driver: ``LDMTrainer``'s step as ``cli train`` runs it,
fed by a card-resident corpus.

Set-up writes a seeded corpus at the reference's scale (``corpus`` in
the mix: images of the configuration's size in ``classes`` classes, and
``pairs`` content/style pairs) as a pack and a pairings CSV under TMPDIR,
loads it with ``DeviceResidentPairs`` (the images on the card as uint8)
and walks it with ``DevicePairLoader`` (shuffled from the seed, whole
batches only).  It builds the trainer with the configuration's training
settings (the step's draws seeded by the run's seed), loads the
benchmark's weights into its model and its two feature trunks, and runs
the first ``check_steps`` steps through the same call and feed as the
window: they build every kernel, and the reference follows them.  What
it keeps of them: each step's loss, the first step's gradients (from
Adam's first moment) and the parameters after the last.  Then the window
runs step after step for ``seconds``, and ends after a synchronise.

The check frees the program, rebuilds the checked batches from the
corpus and the loader's seed, runs the reference's steps from the same
weights in float32, and compares (``compare.train_gaps``).  ``control``
reads the same numbers of the reference in float8 in the program's place
and of a step that averages over half of its batch (``calibrate.py``).
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import compare, tracing
from portbench.reference import nets
from portbench.reference import train as ref_train
from portbench.reference import weights as ref_weights
from portbench.state import device_info, image_pool, limits, release

_ADAM_BETA1 = 0.9


def make_corpus(spec: dict, size: int, rng: np.random.Generator):
    """(images uint8 [n, size, size], labels, class names, pairs)."""
    n, k = spec["images"], spec["classes"]
    images = np.empty((n, size, size), np.uint8)
    for s in range(0, n, 256):
        m = min(256, n - s)
        images[s:s + m] = np.floor(
            image_pool(m, size, rng)[..., 0] * 255.0 + 0.5).astype(np.uint8)
    labels = (np.arange(n) * k // n).astype(np.uint16)
    classes = [f"class{i}" for i in range(k)]
    counts = np.bincount(labels, minlength=k)
    c1 = rng.integers(0, k, spec["pairs"])
    c2 = rng.integers(0, k, spec["pairs"])
    i1 = (rng.random(spec["pairs"]) * counts[c1]).astype(np.int64)
    i2 = (rng.random(spec["pairs"]) * counts[c2]).astype(np.int64)
    pairs = [(classes[a], int(b), classes[c], int(d))
             for a, b, c, d in zip(c1, i1, c2, i2)]
    return images, labels, classes, pairs


def write_corpus(folder: str, corpus) -> tuple:
    from music_style_transfer_ldm_tpu_torch.datasets.packed import write_pack
    images, labels, classes, pairs = corpus
    pack = os.path.join(folder, "corpus.spk")
    table = os.path.join(folder, "pairs.csv")
    write_pack(pack, images, labels, classes)
    with open(table, "w", newline="") as f:
        csv.writer(f).writerows(pairs)
    return pack, table


def reference_batch(corpus, rows: np.ndarray, device):
    """(content, style) unit images [B, S, S] of pair rows, from the
    corpus alone."""
    images, labels, classes, pairs = corpus
    index = {c: np.flatnonzero(labels == i) for i, c in enumerate(classes)}
    c_items = [index[pairs[r][0]][pairs[r][1]] for r in rows]
    s_items = [index[pairs[r][2]][pairs[r][3]] for r in rows]
    unit = images.astype(np.float32) / np.float32(255.0)
    return (torch.as_tensor(unit[c_items], device=device),
            torch.as_tensor(unit[s_items], device=device))


def trainer_config(cell, seed: int):
    from music_style_transfer_ldm_tpu_torch.config import default_config
    cfg = default_config()
    m, t = cell.config["model"], cell.config["train"]["ldm"]
    cfg.model = dataclasses.replace(
        cfg.model, latent_dim=m["latent_dim"],
        unet_num_filters=m["unet_num_filters"],
        style_num_filters=m["style_num_filters"],
        time_emb_dim=m["time_emb_dim"], attn_num_heads=m["attn_num_heads"],
        image_size=m["image_size"])
    cfg.diffusion = dataclasses.replace(
        cfg.diffusion, num_timesteps=m["num_timesteps"],
        beta_start=m["beta_start"], beta_end=m["beta_end"])
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=cell.traffic["batch_size"],
        learning_rate=t["learning_rate"],
        style_loss_weight=t["style_loss_weight"],
        perceptual_weight=t["perceptual_weight"], kl_weight=t["kl_weight"],
        compression_feature_extractor=t["compression_feature_extractor"],
        style_loss_stop_gradient=t["style_loss_stop_gradient"],
        compute_dtype=t["compute_dtype"], style_dropout=0.0, ema_decay=0.0,
        seed=int(seed))
    return cfg


@contextlib.contextmanager
def observe_style_term():
    """Keep each style-loss call's inputs and value while the checked
    steps run (the trainer's ``style_loss``, which runs kernels E and D):
    the check judges the distance the program returned on the images it
    was given, as a served token is judged on its prompt."""
    from music_style_transfer_ldm_tpu_torch.training import train_ldm
    original = train_ldm.style_loss
    seen = []

    def observed(reconstructed, style_spec, feature_loss, weights=None):
        value = original(reconstructed, style_spec, feature_loss, weights)
        seen.append((reconstructed.detach()[..., 0].float().clone(),
                     style_spec.detach()[..., 0].float().clone(),
                     float(value)))
        return value
    train_ldm.style_loss = observed
    try:
        yield seen
    finally:
        train_ldm.style_loss = original


class Feed:
    """Batches of the loader, epoch after epoch."""

    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader)

    def __call__(self):
        try:
            (content, _), (style, _) = next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            (content, _), (style, _) = next(self.it)
        return content, style


def snapshot(state, names):
    params = dict(state.model.named_parameters())
    return {k: params[k].detach().clone() for k in names}


def first_grads(state, names):
    params = dict(state.model.named_parameters())
    return {k: state.optimizer.state[params[k]]["exp_avg"].detach().float()
            / (1.0 - _ADAM_BETA1) for k in names}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t0: float) -> dict:
    from music_style_transfer_ldm_tpu_torch.datasets.device import (
        DevicePairLoader, DeviceResidentPairs,
    )
    from music_style_transfer_ldm_tpu_torch.training.train_ldm import (
        LDMTrainer,
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
    trainer = LDMTrainer(trainer_config(cell, seed), device=dev,
                         compression_feature_params=weights["lpips"],
                         style_feature_params=weights["vggish"])
    state = trainer.init_state(seed=0)
    state.model.load_state_dict(weights["ldm"])
    names = [k for k, p in state.model.named_parameters() if p.requires_grad]
    theta0 = snapshot(state, names)
    feed = Feed(loader)
    losses, grads = [], None
    with observe_style_term() as style_terms:
        for i in range(mix["check_steps"]):
            content, style = feed()
            state, metrics = trainer._step(state, content, style)
            losses.append(metrics)
            if i == 0:
                grads = first_grads(state, names)
    prog = {"losses": [float(m["total_loss"]) for m in losses],
            "style_terms": style_terms, "first_grads": grads,
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
    while True:
        now = time.perf_counter()
        if now - w0 >= seconds:
            break
        if profile is not None:
            profile.tick()
        content, style = feed()
        state, _ = step(state, content, style)
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
    checks, readings, sample, ctx_work = check(
        cell, weights, corpus, loader_seed, seed, prog, theta0, dev, trace)
    ctx = {"cell": cell, "kind": "train", "setup_s": w0 - t0,
           "window_s": w1 - w0, "steps": steps,
           "samples": steps * mix["batch_size"], "spans": spans,
           "trace": summary, "device_kind": info["kind"], "work": ctx_work}
    out = {"attempted": steps, "failed": 0, "ctx": ctx, "device": info,
           "checks": checks, "readings": readings, "sample": sample}
    if summary:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    return out


def check(cell, weights, corpus, loader_seed: int, seed: int, prog: dict,
          theta0: dict, dev, count_work: bool):
    mix, model = cell.traffic, cell.config["model"]
    B = mix["batch_size"]
    order = np.random.RandomState(loader_seed).permutation(len(corpus[3]))
    batches = [reference_batch(corpus, order[i * B:(i + 1) * B], dev)
               for i in range(mix["check_steps"])]
    trunks = {"vggish": weights["vggish"], "lpips": weights["lpips"]}
    tcfg = dict(cell.config["train"]["ldm"], batch_size=B)
    ref = ref_train.ldm_steps(weights["ldm"], trunks, batches, seed, model,
                              tcfg)
    gaps = compare.train_gaps(prog, ref, theta0)
    gaps["style_term_gap"] = compare.style_term_gap(prog["style_terms"],
                                                    trunks["vggish"])
    checks = {k: {"value": gaps[k], "limit": v}
              for k, v in limits(cell).items()}
    work = None
    if count_work:
        work = {"step_flops": compare.step_flops(
            lambda: ref_train.ldm_steps(weights["ldm"], trunks, batches[:1],
                                        seed, model, tcfg))}
    sample = {"weights": weights, "trunks": trunks, "batches": batches,
              "tcfg": tcfg, "theta0": theta0, "ref": ref,
              "style_terms": prog["style_terms"]}
    return checks, gaps, sample, work


def control(cell, smp: dict, seed: int, device=None) -> dict:
    """The compared numbers of the control (the reference's steps with the
    model's products in float8 e4m3, gradients e5m2) and of a step over
    half of each checked batch, against the reference's steps."""
    model = cell.config["model"]
    fp8 = nets.Precision("fp8")
    ctrl = ref_train.ldm_steps(smp["weights"]["ldm"], smp["trunks"],
                               smp["batches"], seed, model, smp["tcfg"], fp8)
    half = [(c[:c.shape[0] // 2], s[:s.shape[0] // 2])
            for c, s in smp["batches"]]
    halved = ref_train.ldm_steps(smp["weights"]["ldm"], smp["trunks"], half,
                                 seed, model, smp["tcfg"])
    readings = compare.train_gaps(ctrl, smp["ref"], smp["theta0"])
    readings["style_term_gap"] = compare.style_term_gap(
        smp["style_terms"], smp["trunks"]["vggish"], fp8)
    return {"control": readings,
            "half_batch": compare.train_gaps(halved, smp["ref"],
                                             smp["theta0"])}
