#!/usr/bin/env python3
"""Card and wall time of Riffusion's UNet call and VAE passes at the
serving shapes, on one card.

    python tools/torch_riffusion_unet_times.py [--rows 8] [--clips 4]

Builds Riffusion from seeded weights (bf16, channels-last, as
``load_riffusion`` serves it), then times the UNet at ``--rows`` rows
(64x64 latents, 77 text tokens: a dispatch of rows / 2 guided clips) and
the VAE's encode and decode of ``--clips`` 512x512 images, each over
``--reps`` calls back to back:

- ``wall_ms``: host clock a call, the calls ended by a synchronise;
- ``busy_ms``: the card's kernel and copy time a call (torch.profiler,
  summed; one stream, so nothing overlaps);
- ``kernels``: kernels and copies a call.

``busy_ms`` well under ``wall_ms`` means the host, issuing the calls,
paces them.  Prints one JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from music_style_transfer_ldm_tpu_torch.utils.chips import (  # noqa: E402
    resolve_device,
)
from tools.torch_common import power_limit  # noqa: E402


def timed(fn, reps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA"]
    return {"wall_ms": wall_ms,
            "busy_ms": sum(e.device_time_total for e in events) / 1e3 / reps,
            "kernels": sum(e.count for e in events) / reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--clips", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")   # card time only: no CPU route
    from music_style_transfer_ldm_tpu_torch.models.riffusion import (
        build_riffusion,
    )
    model = build_riffusion(device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    z = torch.randn(args.rows, 4, 64, 64, device=dev, generator=g)
    t = torch.full((args.rows,), 500, device=dev)
    ctx = torch.randn(args.rows, 77, 768, device=dev, generator=g)
    img = torch.rand(args.clips, 3, 512, 512, device=dev, generator=g)
    lat = torch.randn(args.clips, 4, 64, 64, device=dev, generator=g)
    parts = {"unet": lambda: model.unet(z, t, ctx),
             "vae_encode": lambda: model.vae.encode_mean(img),
             "vae_decode": lambda: model.vae.decode(lat)}
    out = {"card": power_limit(dev), "rows": args.rows, "clips": args.clips}
    with torch.no_grad():
        for name, fn in parts.items():
            out[name] = timed(fn, args.reps)
            print(f"{name}: {out[name]}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
