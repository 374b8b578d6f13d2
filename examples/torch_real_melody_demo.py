#!/usr/bin/env python3
"""Real-melody demo on the port: the full product path on public-domain
melodies instead of random note soup.

The port's counterpart of ``examples/real_melody_demo.py``: Ode to Joy /
Twinkle Twinkle / Greensleeves rendered in four instrument voices
(``examples/melodies.py``), then only the port's CLI: build-dataset ->
generate-pairings -> train autoencoder -> train ldm -> transfer (Ode to
Joy on violin -> piano style, with --match-level, content phases and
overlapping chunks) -> diagnose.

    python examples/torch_real_melody_demo.py [--workdir DIR] [--epochs N] \
        [--steps N] [--seconds S] [--out DIR] [--device cpu]

The transferred WAV and spectrogram PNG, and the violin input, land in
--out (default ``runs/torch/demo_output``; ``examples/demo_output``
holds the JAX package's committed artifacts and is not written).
stderr ends with the kernels' launch line.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from examples.melodies import MELODIES, VOICES, render_melody  # noqa: E402
from tools.torch_common import (  # noqa: E402
    add_device_arg, device_of, print_launches,
)


def synthesize_corpus(workdir: Path, min_seconds: float) -> None:
    from music_style_transfer_ldm_tpu_torch.audio.io import write_wav
    for voice in VOICES:
        d = workdir / "downloads" / voice
        d.mkdir(parents=True, exist_ok=True)
        for melody in MELODIES:
            y = render_melody(melody, voice, min_seconds=min_seconds)
            write_wav(d / f"{melody}.wav", y, 22050)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default=str(REPO / "runs" / "torch"
                                            / "melody_demo_run"))
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seconds", type=float, default=60.0,
                   help="min audio per melody rendition")
    p.add_argument("--out", default=str(REPO / "runs" / "torch"
                                        / "demo_output"))
    add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device_of(args)
    dev = ["--device", args.device]

    out = Path(args.out).resolve()
    workdir = Path(args.workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    os.chdir(workdir)
    synthesize_corpus(Path("."), args.seconds)

    from music_style_transfer_ldm_tpu_torch.cli import main as cli
    for argv_ in (
            ["build-dataset", *dev],
            ["generate-pairings", "--num-pairs", "512"],
            ["train", "--model", "autoencoder", "--epochs", str(args.epochs),
             "--out-dir", "runs/ae", *dev],
            ["train", "--model", "ldm", "--epochs", str(args.epochs),
             "--pretrained-ae", "runs/ae/pretrained.pt", "--out-dir",
             "runs/ldm", *dev],
            # the product artifact: a recognizable melody in another
            # timbre, with dynamic-range matching, content-phase
            # Griffin-Lim and crossfaded overlapping chunks
            ["transfer", "--checkpoint", "runs/ldm/ldm_final.pt",
             "--content", "downloads/violin/ode_to_joy.wav",
             "--style", "processed_images/piano/greensleeves_chunk0.png",
             "--steps", str(args.steps), "--match-level",
             "--phase-init", "content", "--overlap", "0.5",
             "--output", "out/ode_to_joy_as_piano", *dev],
            ["diagnose", "--checkpoint", "runs/ldm/ldm_final.pt", *dev]):
        rc = cli(argv_)
        if rc:
            raise SystemExit(f"cli {argv_[0]} exited {rc}")

    out.mkdir(parents=True, exist_ok=True)
    for f in Path("out").glob("ode_to_joy_as_piano.*"):
        shutil.copy2(f, out / f.name)
    from music_style_transfer_ldm_tpu_torch.audio.io import write_wav
    write_wav(out / "ode_to_joy_violin_input.wav",
              render_melody("ode_to_joy", "violin", min_seconds=9.0), 22050)
    print("\ndemo artifacts ->", out)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
