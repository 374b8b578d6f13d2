#!/usr/bin/env python3
"""Where the serving engine's replicas part from one replica (f32, card).

The flagship LDM at full width (random weights from seed 0, f32), the
scan DDIM route with audio (NNLS and Griffin-Lim on the card), seeded
requests.  A bucket of ``--bucket`` rows over two replicas on the one
card (``make_mesh((2, 1), devices=[cuda:0, cuda:0])``) runs half the
rows on each replica, each on its own CUDA stream.  Printed as the max
abs difference of the images and of the audio:

* ``repeat``: one replica twice on the same half of the rows;
* ``side_stream``: one replica on a side stream against the default
  stream, on the same rows;
* ``batch``: one replica on half the rows against the same rows inside
  the whole bucket;
* ``replicas``: the two replicas against one replica on each half;
* ``audio_*``: the audio stage alone (NNLS and Griffin-Lim) on one fixed
  decoded image batch, twice on the default stream (``audio_repeat``)
  and once on a side stream (``audio_side_stream``);

each with cuDNN's deterministic flag off and on.  One JSON line per
setting, with CUBLAS_WORKSPACE_CONFIG and the card's name and power
limit.

    python tools/torch_replica_spread.py [--bucket 4]
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python tools/torch_replica_spread.py
"""

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm  # noqa: E402,E501
from music_style_transfer_ldm_tpu_torch.parallel import make_mesh  # noqa: E402,E501
from music_style_transfer_ldm_tpu_torch.serving.engine import (  # noqa: E402
    EngineConfig, InferenceEngine,
)


def gap(a: dict, b: dict) -> dict:
    return {k: float(np.abs(a[k] - b[k]).max()) for k in ("image", "audio")}


def on_stream(stream, fn):
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        out = fn()
    stream.synchronize()
    return out


def readings(bucket: int, deterministic: bool) -> dict:
    torch.backends.cudnn.deterministic = deterministic
    card = torch.device("cuda", 0)
    ldm = build_ldm(dtype=torch.float32, device=card, seed=0)
    one = InferenceEngine(ldm, EngineConfig(sampler="ddim"))
    two = InferenceEngine(ldm, EngineConfig(sampler="ddim"),
                          mesh=make_mesh((2, 1), devices=[card, card]))
    one.warmup()
    two.warmup()
    rng = np.random.RandomState(0)
    c = rng.rand(bucket, 128, 128, 1).astype(np.float32)
    s = rng.rand(bucket, 128, 128, 1).astype(np.float32)
    seeds = 40 + np.arange(bucket)
    half = bucket // 2

    def block(i, engine=one):
        rows = slice(i * half, (i + 1) * half)
        return engine.transfer_batch(c[rows], s[rows], seeds=seeds[rows])

    def halves(outs):
        return {k: np.concatenate([o[k] for o in outs])
                for k in ("image", "audio")}

    side = torch.cuda.Stream(card)
    first = block(0)
    out = {
        "repeat": gap(first, block(0)),
        "side_stream": gap(first, on_stream(side, lambda: block(0))),
    }
    blocks = halves([first, block(1)])
    whole = one.transfer_batch(c, s, seeds=seeds)
    out["batch"] = gap(blocks, whole)
    out["replicas"] = gap(two.transfer_batch(c, s, seeds=seeds), blocks)
    decoded = torch.as_tensor(first["image"], device=card)
    with torch.no_grad():
        a0 = one._finish_outputs(decoded)["audio"].cpu().numpy()
        a1 = one._finish_outputs(decoded)["audio"].cpu().numpy()
        a2 = on_stream(side, lambda: one._finish_outputs(decoded)[
            "audio"].cpu().numpy())
    out["audio_repeat"] = float(np.abs(a0 - a1).max())
    out["audio_side_stream"] = float(np.abs(a0 - a2).max())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bucket", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    for deterministic in (False, True):
        print(json.dumps({
            "card": card, "bucket": args.bucket,
            "cudnn_deterministic": deterministic,
            "cublas_workspace_config": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            **readings(args.bucket, deterministic)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
