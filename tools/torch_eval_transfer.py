#!/usr/bin/env python3
"""Quantitative transfer evaluation on held-out pairs, on the port.

The port's counterpart of ``tools/eval_transfer.py``, under its JSON
keys: pixel-space MSEs between content, style, the transfer output and
the autoencoder's reconstruction of the content; the VGGish style
distance under the seed-3 trunk and its reduction from the
content-vs-style baseline; the training-independent block
(``evaluation.independent_transfer_metrics``, seeds 11 and 29); and the
same block after ``match_moments`` (``level_matched``).

On the card the transfer takes the scan route (kernel B each DDIM
step) and the f32 VGGish distances run kernel E's value-only form with
kernel D inside it.  The port's seeded trunks come from PyTorch's
generator, so the seed-3 trunk is the port's own, not the JAX package's
trunk of the same seed (``style_trunk_note`` says so).  Each held-out
pair draws its own noise (seed = its row).

    python tools/torch_eval_transfer.py --checkpoint runs/ldm/ldm_final.pt \
        --pack train.spk --pairings pairings.csv \
        [--out-dir runs/torch/eval] [--device cpu]

Writes ``<json-name>`` and a content / style / transfer panel
(grayscale PNG, rows in that order, low frequencies at the bottom) to
--out-dir; stderr ends with the kernels' launch line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.torch_common import (  # noqa: E402
    REPO, add_device_arg, device_of, held_out_pairs, print_launches,
)

STYLE_TRUNK_SEED = 3     # the training style loss's trunk (train.seed + 3)
INDEPENDENT_SEEDS = (11, 29)


def transfer_metrics(content: np.ndarray, style: np.ndarray,
                     decoded: np.ndarray, recon: np.ndarray, device,
                     trunks: dict | None = None) -> dict:
    """The JAX tool's metric block on [N, H, W, 1] arrays in [0, 1]
    (``recon``: the autoencoder's reconstruction of ``content``).
    ``trunks`` maps a VGGish seed to a state dict (the seed-3 trunk
    included); a seed it lacks gets the port's seeded trunk."""
    from music_style_transfer_ldm_tpu_torch.evaluation import (
        independent_transfer_metrics,
    )
    from music_style_transfer_ldm_tpu_torch.losses.feature import (
        build_feature_metric,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import match_moments
    trunks = trunks or {}

    def mse(a, b):
        return float(np.mean((a - b) ** 2))
    vgg = build_feature_metric("vggish", torch.float32,
                               seed=STYLE_TRUNK_SEED, device=device,
                               params=trunks.get(STYLE_TRUNK_SEED))
    dev = next(vgg.module.parameters()).device

    def dist(a, b):
        with torch.no_grad():
            return float(vgg.distance(
                torch.as_tensor(a, dtype=torch.float32, device=dev),
                torch.as_tensor(b, dtype=torch.float32, device=dev)))

    base = dist(content, style)
    got = dist(decoded, style)
    indep = independent_transfer_metrics(content, style, decoded,
                                         seeds=INDEPENDENT_SEEDS,
                                         device=device, trunks=trunks)
    matched = match_moments(torch.as_tensor(decoded),
                            torch.as_tensor(style)).numpy()
    indep_matched = independent_transfer_metrics(
        content, style, matched, seeds=INDEPENDENT_SEEDS, device=device,
        trunks=trunks)
    return {
        "pixel_mse_transfer_vs_content": round(mse(decoded, content), 4),
        # sampler-induced content drift, the AE floor factored out
        "pixel_mse_transfer_vs_content_recon": round(mse(decoded, recon), 4),
        "pixel_mse_recon_vs_content": round(mse(recon, content), 4),
        "pixel_mse_transfer_vs_style": round(mse(decoded, style), 4),
        "pixel_mse_content_vs_style_baseline": round(mse(content, style), 4),
        "vggish_distance_transfer_vs_style": round(got, 4),
        "vggish_distance_content_vs_style_baseline": round(base, 4),
        "style_distance_reduction_pct": round(100 * (1 - got / base), 1),
        "style_trunk_note": (
            "seed-3 trunk == the port's training style-loss trunk (PyTorch's "
            "generator: not the JAX package's seed-3 trunk); independent "
            "metrics below"),
        **indep,
        "level_matched": indep_matched,
    }


def panel_image(rows, n: int = 4) -> np.ndarray:
    """uint8 grid: one row per [N, H, W, 1] set in [0, 1], its first
    ``n`` images side by side, each flipped so that low mel bands sit at
    the bottom, 2-pixel white gutters."""
    n = min(n, len(rows[0]))
    h, w = rows[0].shape[1:3]
    gap = 2
    grid = np.full((len(rows) * (h + gap) - gap, n * (w + gap) - gap), 255,
                   np.uint8)
    for r, imgs in enumerate(rows):
        for j in range(n):
            img = np.clip(np.asarray(imgs[j])[::-1, :, 0], 0.0, 1.0)
            grid[r * (h + gap):r * (h + gap) + h,
                 j * (w + gap):j * (w + gap) + w] = np.round(img * 255)
    return grid


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--pack", required=True)
    p.add_argument("--pairings", required=True)
    p.add_argument("--n-pairs", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", choices=["ddim", "dpm++"], default="ddim")
    p.add_argument("--sample-steps", type=int, default=None,
                   help="coarse sampler grid (pairs with --sampler dpm++)")
    p.add_argument("--guidance", type=float, default=1.0,
                   help="classifier-free style-guidance scale (needs a "
                        "style_dropout-trained checkpoint)")
    p.add_argument("--out-dir", default=str(REPO / "runs" / "torch"
                                            / "eval"))
    p.add_argument("--json-name", default="transfer_eval.json")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.models.ldm import (
        content_style_transfer, load_ldm,
    )
    from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

    ldm = load_ldm(default_config(), full_checkpoint=args.checkpoint,
                   device=dev)
    content, style = held_out_pairs(args.pack, args.pairings, args.n_pairs)
    n = len(content)
    print(f"{n} held-out pairs (test split), steps={args.steps}",
          flush=True)

    content_t = torch.as_tensor(content, device=dev)
    decoded, _ = content_style_transfer(
        ldm, content_t, torch.as_tensor(style, device=dev),
        num_timesteps=args.steps, sampler=args.sampler,
        steps=args.sample_steps, guidance=args.guidance,
        seeds=np.arange(n))
    decoded = decoded.float().cpu().numpy()
    # content preservation against what a zero-drift transfer could
    # return: the autoencoder's own reconstruction of the content
    recon = ((ldm.decode(ldm.encode(content_t)).float() + 1.0) / 2.0
             ).cpu().numpy()

    results = {
        "n_pairs": n,
        "steps": args.steps,
        **transfer_metrics(content, style, decoded, recon, dev),
        "sampler": args.sampler,
        "sample_steps": args.sample_steps,
        "guidance": args.guidance,
        "checkpoint": str(args.checkpoint),
        "eval_backend": dev.type,
    }
    print(json.dumps(results, indent=2), flush=True)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / args.json_name).write_text(json.dumps(results, indent=2) + "\n")
    panel = out / (Path(args.json_name).stem.replace("_eval", "")
                   + "_panel.png")
    panel.write_bytes(write_png_gray(panel_image([content, style,
                                                  decoded])))
    print(f"panel -> {panel}", flush=True)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
