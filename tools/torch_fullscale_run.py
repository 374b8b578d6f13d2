#!/usr/bin/env python3
"""The reference recipe at full scale, on the port.

The port's counterpart of ``tools/fullscale_run.py``: 4 instruments x 30
min of synthetic audio -> 3 s chunks -> 2,400 mel images (the ETL,
kernel C) -> 15,000 seed-42 pairings -> a spec pack; the autoencoder for
``--ae-epochs`` at B=128, then the LDM for ``--ldm-epochs`` at B=128 from
its frozen encoder (kernels E and D in the style and compression
terms), fed by ``PackedBatchLoader`` over the pack or, with
``--device-resident``, by the corpus on the card.  Then
``measure_pipeline``: sustained samples/s with the loader in the loop
and the share of wall time spent waiting on it (no synchronise inside
the loop; the loss is read once at the end), and the step-time
distribution with a synchronise after every step.

    python tools/torch_fullscale_run.py --workdir runs/torch/fullscale \
        [--seconds 1800] [--pairs 15000] [--ae-epochs 100] \
        [--ldm-epochs 202] [--resume-ldm CKPT] [--device-resident] \
        [--results-dir runs/torch/fullscale/results] [--device cpu]

Stages are idempotent: existing dataset artifacts and a finished
autoencoder phase are kept.  The results directory gets
``pipeline_measurement.json`` (the JAX keys, plus ``power_limit``) and
the two metrics CSVs; no loss plot (the card's machine has no
matplotlib).  stderr ends with the kernels' launch line.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.torch_common import (  # noqa: E402
    REPO, add_device_arg, chip_name, device_of, power_limit, print_launches,
)

EXTRA_KEYS = ("power_limit",)
SR = 22050

# Additive-synthesis voices: (harmonic amplitudes, decay/s, vibrato Hz).
# Four timbres standing in for the reference's four instruments (piano,
# guitar, violin, harp); a copy of the JAX tool's.
VOICES = {
    "piano": ([1.0, 0.45, 0.22, 0.1, 0.05], 3.0, 0.0),
    "guitar": ([1.0, 0.6, 0.25, 0.12, 0.08, 0.05], 5.0, 0.0),
    "violin": ([1.0, 0.35, 0.3, 0.15, 0.1], 0.3, 5.5),
    "harp": ([1.0, 0.3, 0.12, 0.04], 7.0, 0.0),
}
SCALE_HZ = [220.0, 246.94, 277.18, 293.66, 329.63, 369.99, 415.3, 440.0,
            493.88, 554.37, 587.33, 659.26]


def synthesize_instrument(name: str, seconds: float,
                          seed: int) -> np.ndarray:
    """Random note sequence with the instrument's harmonic profile."""
    harmonics, decay, vibrato = VOICES[name]
    rng = np.random.RandomState(seed)
    y = np.zeros(int(seconds * SR), np.float32)
    pos = 0
    while pos < len(y):
        dur = rng.uniform(0.2, 1.0)
        n = min(int(dur * SR), len(y) - pos)
        t = np.arange(n) / SR
        f0 = SCALE_HZ[rng.randint(len(SCALE_HZ))] * 2.0 ** rng.randint(-1, 2)
        if vibrato:
            f0 = f0 * (1 + 0.01 * np.sin(2 * np.pi * vibrato * t))
        env = np.exp(-decay * t) * np.minimum(1.0, t * 200.0)
        note = sum(a * np.sin(2 * np.pi * f0 * (k + 1) * t)
                   for k, a in enumerate(harmonics))
        y[pos:pos + n] += (0.3 * rng.uniform(0.6, 1.0)
                           * env * note).astype(np.float32)
        pos += n
    return 0.5 * y / max(1e-6, np.abs(y).max())


def prepare_dataset(workdir: Path, seconds: float, pairs: int,
                    device="cuda") -> None:
    from music_style_transfer_ldm_tpu_torch.audio.io import write_wav
    from music_style_transfer_ldm_tpu_torch.data.build_dataset import (
        build_dataset_folder_structure,
    )
    from music_style_transfer_ldm_tpu_torch.datasets import (
        build_pack, generate_pairings,
    )
    dl = workdir / "downloads"
    if not dl.exists():
        for i, name in enumerate(VOICES):
            d = dl / name
            d.mkdir(parents=True)
            t0 = time.time()
            write_wav(d / "session.wav",
                      synthesize_instrument(name, seconds, seed=100 + i), SR)
            print(f"synthesized {name}: {seconds:.0f}s "
                  f"({time.time() - t0:.1f}s)", flush=True)
    img_root = workdir / "processed_images"
    if not img_root.exists():
        n = build_dataset_folder_structure(str(dl), str(img_root),
                                           batch_chunks=128, device=device)
        print(f"built {n} spectrogram images", flush=True)
    csv = workdir / "pairings.csv"
    if not csv.exists():
        generate_pairings(img_root, csv, num_pairs=pairs, seed=42)
        print(f"generated {pairs} pairings", flush=True)
    pack = workdir / "train.spk"
    if not pack.exists():
        n = build_pack(img_root, pack)
        print(f"packed {n} items -> {pack} "
              f"({pack.stat().st_size / 1e6:.1f} MB)", flush=True)


def measure_pipeline(trainer, state, loader, n_steps: int = 100,
                     n_synced: int = 50) -> dict:
    """Sustained throughput and loader occupancy with no synchronise in
    the loop (the loss read once at the end), then the per-step latency
    with a synchronise after every step."""
    from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
        step_rows,
    )

    def prep(i, batch):
        (content, _), (style, _) = batch
        (content, style), w = step_rows((content, style), trainer.mesh,
                                        loader, i,
                                        trainer.sequence_parallel)
        return content, style, ({} if w is None else {"weights": w})

    # Pipelined pass: time blocked on the loader, no synchronise.
    it = iter(loader)
    batch = next(it)
    steps, fetch_s = 0, 0.0
    t0 = time.perf_counter()
    metrics = None
    while steps < n_steps and batch is not None:
        content, style, kw = prep(steps, batch)
        state, metrics = trainer._step(state, content, style, **kw)
        steps += 1
        tf = time.perf_counter()
        batch = next(it, None)
        fetch_s += time.perf_counter() - tf
    float(metrics["total_loss"])     # the one read back: the card drains
    wall = time.perf_counter() - t0
    bsz = loader.batch_size
    result = {
        "pipelined_steps": steps,
        "sustained_samples_per_s": round(steps * bsz / wall, 1),
        "pipelined_step_ms": round(wall / steps * 1000, 2),
        "loader_wait_frac": round(fetch_s / wall, 4),
    }

    # Synced pass: per-step latency distribution.
    times = []
    it = iter(loader)
    for i in range(n_synced):
        batch = next(it, None)
        if batch is None:
            break
        content, style, kw = prep(i, batch)
        t1 = time.perf_counter()
        state, metrics = trainer._step(state, content, style, **kw)
        float(metrics["total_loss"])
        times.append(time.perf_counter() - t1)
    times_ms = np.asarray(times) * 1000
    result.update({
        "synced_steps": len(times),
        "synced_step_ms_p50": round(float(np.percentile(times_ms, 50)), 2),
        "synced_step_ms_p90": round(float(np.percentile(times_ms, 90)), 2),
        "synced_step_ms_p99": round(float(np.percentile(times_ms, 99)), 2),
    })
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=str(REPO / "runs" / "torch"
                                            / "fullscale"))
    p.add_argument("--seconds", type=float, default=1800.0)
    p.add_argument("--pairs", type=int, default=15000)
    p.add_argument("--ae-epochs", type=int, default=100)
    p.add_argument("--ldm-epochs", type=int, default=202)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--resume-ldm", default=None)
    p.add_argument("--device-resident", action="store_true",
                   help="keep the whole pack on the card and gather "
                        "batches there (datasets/device.py) instead of "
                        "streaming uint8 batches from the host")
    p.add_argument("--results-dir", default=None,
                   help="default: <workdir>/results")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    import dataclasses

    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.datasets import (
        DevicePairLoader, DeviceResidentPairs, PackedBatchLoader,
        PackedPairDataset, PackedSpectrogramDataset, train_test_split,
    )
    from music_style_transfer_ldm_tpu_torch.training import (
        AETrainer, LDMTrainer, checkpoint as ckpt_lib,
    )

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"device: {chip_name(dev)} ({dev})", flush=True)

    prepare_dataset(workdir, args.seconds, args.pairs, dev)

    cfg = default_config()
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=args.batch, ckpt_every_epochs=50,
        # the trainable style term (the reference's no_grad quirk keeps
        # its style loss flat), as the JAX tool's flagship run
        style_loss_stop_gradient=False)

    # ---- phase 1: autoencoder ------------------------------------------
    ae_dir = workdir / "runs" / "ae"
    t_ae = 0.0
    if not (ae_dir / "pretrained_final.pt").exists():
        ds = PackedSpectrogramDataset(workdir / "train.spk")
        print(f"AE dataset: {len(ds)} images, native={ds.native}",
              flush=True)
        tr, te = train_test_split(len(ds), cfg.train.train_split,
                                  seed=cfg.train.seed)
        tl = PackedBatchLoader(ds, args.batch, indices=tr, shuffle=True,
                               seed=cfg.train.seed, dtype="uint8")
        vl = PackedBatchLoader(ds, args.batch, indices=te, shuffle=False,
                               dtype="uint8")
        ae = AETrainer(cfg, device=dev)
        t0 = time.time()
        ae.train(tl, vl, num_epochs=args.ae_epochs, out_dir=ae_dir)
        t_ae = time.time() - t0
        print(f"AE phase: {args.ae_epochs} epochs in {t_ae:.0f}s", flush=True)

    # ---- phase 2: LDM ----------------------------------------------------
    ldm_dir = workdir / "runs" / "ldm"
    trainer = LDMTrainer(cfg, device=dev)
    if args.device_resident:
        pair_ds = DeviceResidentPairs(workdir / "train.spk",
                                      workdir / "pairings.csv",
                                      mesh=trainer.mesh)
        print(f"pair dataset: {len(pair_ds)} pairs, device-resident "
              f"({pair_ds.nbytes / 1e6:.0f} MB on {dev})", flush=True)
        tr, _ = train_test_split(len(pair_ds), cfg.train.train_split,
                                 seed=cfg.train.seed)
        train_loader = DevicePairLoader(pair_ds, args.batch, indices=tr,
                                        shuffle=True, seed=cfg.train.seed)
    else:
        pair_ds = PackedPairDataset(workdir / "train.spk",
                                    workdir / "pairings.csv")
        print(f"pair dataset: {len(pair_ds)} pairs, "
              f"native={pair_ds.pack.native}", flush=True)
        tr, _ = train_test_split(len(pair_ds), cfg.train.train_split,
                                 seed=cfg.train.seed)
        train_loader = PackedBatchLoader(pair_ds, args.batch, indices=tr,
                                         shuffle=True, seed=cfg.train.seed,
                                         dtype="uint8")
    pre = ckpt_lib.load_autoencoder(ae_dir / "pretrained.pt")
    t0 = time.time()
    state = trainer.train(train_loader, num_epochs=args.ldm_epochs,
                          pretrained_autoencoder=pre, out_dir=ldm_dir,
                          resume_from=args.resume_ldm)
    t_ldm = time.time() - t0
    steps_per_epoch = len(train_loader)
    print(f"LDM phase: {args.ldm_epochs} epochs x {steps_per_epoch} steps "
          f"in {t_ldm:.0f}s", flush=True)

    # ---- pipeline measurement -------------------------------------------
    meas = measure_pipeline(trainer, state, train_loader)
    meas.update({
        "pairs": len(pair_ds), "train_pairs": len(tr),
        "batch_size": args.batch,
        "steps_per_epoch": steps_per_epoch,
        "ldm_epochs": args.ldm_epochs,
        "ldm_wall_s": round(t_ldm, 1),
        "ae_wall_s": round(t_ae, 1),
        "epoch_s_sustained": round(t_ldm / max(args.ldm_epochs, 1), 2),
        "device": f"{chip_name(dev)} ({dev})",
        "power_limit": power_limit(dev),
    })
    print(json.dumps(meas, indent=2), flush=True)

    # ---- collect artifacts ----------------------------------------------
    results = Path(args.results_dir or workdir / "results")
    results.mkdir(parents=True, exist_ok=True)
    (results / "pipeline_measurement.json").write_text(
        json.dumps(meas, indent=2) + "\n")
    for src, dst in [(ldm_dir / "metrics.csv", "ldm_metrics_fullscale.csv"),
                     (ae_dir / "metrics.csv", "ae_metrics_fullscale.csv")]:
        if src.exists():
            shutil.copy(src, results / dst)
    print(f"artifacts -> {results}", flush=True)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
