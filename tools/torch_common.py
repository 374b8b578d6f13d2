"""What the port's tools (``tools/torch_*.py``, ``examples/torch_*.py``)
share: the ``--device`` flag, the card's name and power limit for the
records, and the kernels' launch line.

A tool runs on the card unless the caller passes ``--device cpu``;
without a card it refuses to start (``utils/chips.py resolve_device``).
After its work it prints ``kernel launches: {json}`` to stderr, each
kernel wrapper's launch count in this process, so a caller that runs the
tool in a process of its own can read which kernels its path took.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device

REPO = Path(__file__).resolve().parent.parent


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the kernels' plain "
                             "PyTorch versions (tests)")


def device_of(args) -> torch.device:
    """The device ``--device`` names; raises when it is a card and none is
    present."""
    return resolve_device(args.device)


def power_limit(dev: torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, None off the card."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[dev.index or 0].strip()


def chip_name(dev: torch.device) -> str:
    """``torch.cuda.get_device_name`` on the card, else 'cpu'."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def print_launches() -> None:
    """Each kernel wrapper's launch count in this process (A, B, C, D
    forward and backward, E), as one stderr line."""
    from music_style_transfer_ldm_tpu_torch.benchmarks import _launch_counts
    print(f"kernel launches: {json.dumps(_launch_counts())}",
          file=sys.stderr, flush=True)


def held_out_pairs(pack, pairings, n_pairs: int):
    """(content, style) [n, 128, 128, 1] float32 in [0, 1]: the first
    ``n_pairs`` pairs of the test split (``train_test_split`` at the
    config's fraction and seed), as the JAX eval tools select them."""
    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.datasets import (
        PackedPairDataset, train_test_split,
    )
    cfg = default_config()
    ds = PackedPairDataset(pack, pairings)
    _, held = train_test_split(len(ds), cfg.train.train_split,
                               seed=cfg.train.seed)
    return ds.gather_pairs(held[:n_pairs])
