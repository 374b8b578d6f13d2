#!/usr/bin/env python3
"""End-to-end demo on the port: synthesize a tiny dataset, train both
phases, run a style transfer, write audio, through the port's CLI.

The port's counterpart of ``examples/end_to_end_demo.py``, with the same
CLI calls (``build-dataset``, ``generate-pairings``, ``train --model
autoencoder``, ``train --model ldm --pretrained-ae``, ``transfer``,
``diagnose``) on ``music_style_transfer_ldm_tpu_torch.cli``.

    python examples/torch_end_to_end_demo.py [--workdir DIR] [--epochs N] \
        [--steps N] [--device cpu]

Runs on the card unless ``--device cpu``; everything is written under
--workdir (default ``runs/torch/demo_run``).  stderr ends with the
kernels' launch line.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from tools.torch_common import (  # noqa: E402
    add_device_arg, device_of, print_launches,
)


def synthesize_dataset(workdir: Path, seconds: float = 30.0) -> None:
    from music_style_transfer_ldm_tpu_torch.audio.io import write_wav
    sr = 22050
    rng = np.random.RandomState(0)
    t = np.arange(int(seconds * sr)) / sr
    voices = {
        "piano": np.exp(-((t % 0.5) * 6)) * sum(
            a * np.sin(2 * np.pi * 262 * (k + 1) * t)
            for k, a in enumerate([0.5, 0.25, 0.12])),
        "violin": sum(a * np.sin(2 * np.pi * 440 * (k + 1)
                                 * t * (1 + 0.01 * np.sin(2 * np.pi * 5 * t)))
                      for k, a in enumerate([0.4, 0.3, 0.2])),
        "flute": 0.5 * np.sin(2 * np.pi * 523 * t) + 0.05 * rng.randn(len(t)),
    }
    for name, y in voices.items():
        d = workdir / "downloads" / name
        d.mkdir(parents=True, exist_ok=True)
        y = 0.5 * y / np.max(np.abs(y))
        write_wav(d / "clip.wav", y.astype(np.float32), sr)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=str(REPO / "runs" / "torch"
                                            / "demo_run"))
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--steps", type=int, default=20)
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device_of(args)
    dev = ["--device", args.device]

    workdir = Path(args.workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    os.chdir(workdir)

    synthesize_dataset(Path("."))

    from music_style_transfer_ldm_tpu_torch.cli import main as cli
    for argv_ in (
            ["build-dataset", *dev],
            ["generate-pairings", "--num-pairs", "64"],
            ["train", "--model", "autoencoder", "--epochs", str(args.epochs),
             "--out-dir", "runs/ae", *dev],
            ["train", "--model", "ldm", "--epochs", str(args.epochs),
             "--pretrained-ae", "runs/ae/pretrained.pt", "--out-dir",
             "runs/ldm", *dev],
            ["transfer", "--checkpoint", "runs/ldm/ldm_final.pt",
             "--content", "downloads/flute/clip.wav",
             "--style", "processed_images/piano/clip_chunk0.png",
             "--steps", str(args.steps), "--output", "out/transferred",
             *dev],
            ["diagnose", "--checkpoint", "runs/ldm/ldm_final.pt", *dev]):
        rc = cli(argv_)
        if rc:
            raise SystemExit(f"cli {argv_[0]} exited {rc}")
    print("\ndemo complete — see", Path.cwd() / "out")
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
