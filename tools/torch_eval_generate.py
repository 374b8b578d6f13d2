#!/usr/bin/env python3
"""Quantitative eval of style-conditioned generation, on the port.

The port's counterpart of ``tools/eval_generate.py``, under its JSON
keys: ``--n`` images generated from noise (``style_ddim_sample``, the
scan route: kernel B each DDIM step) conditioned on styles of one pack
class, scored against that class's corpus by

* FAD(generated, style corpus) over f32 VGGish trunk embeddings
  (``evaluation.trunk_embeddings``, seed 11), with the real-vs-real
  floor (two disjoint halves of the class) and the other-class ceiling;
* the log-mel band-statistics distance to the corpus, beside the
  real-vs-real one;
* diversity: the mean pairwise pixel distance of the generated set and
  of the real corpus.

The seed-11 trunk is the port's own (PyTorch's generator).

    python tools/torch_eval_generate.py --checkpoint runs/ldm/ldm_final.pt \
        --pack train.spk --style-class 0 --n 16 [--steps 100] \
        [--sampler ddim|dpm++] [--guidance g] [--out F.json] [--device cpu]

stderr ends with the kernels' launch line.
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
    add_device_arg, device_of, print_launches,
)

TRUNK_SEED = 11


def pairwise_spread(imgs: np.ndarray) -> float:
    """Mean pairwise L2 distance between flattened images."""
    x = np.asarray(imgs, np.float64).reshape(len(imgs), -1)
    d = np.sqrt(np.maximum(
        (x * x).sum(1)[:, None] + (x * x).sum(1)[None, :] - 2 * x @ x.T,
        0.0))
    n = len(x)
    return float(d.sum() / max(n * (n - 1), 1))


def generation_metrics(generated: np.ndarray, corpus_a: np.ndarray,
                       corpus_b: np.ndarray, mismatch: np.ndarray, device,
                       trunks: dict | None = None) -> dict:
    """The JAX tool's FAD, floor, ceiling, band-statistics and spread
    keys; ``trunks`` may give the seed-11 trunk's state dict."""
    from music_style_transfer_ldm_tpu_torch.evaluation import (
        frechet_distance, log_mel_stats_distance, trunk_embeddings,
    )
    params = (trunks or {}).get(TRUNK_SEED)
    e_gen, e_a, e_b, e_o = (
        trunk_embeddings(x, seed=TRUNK_SEED, device=device, params=params)
        for x in (generated, corpus_a, corpus_b, mismatch))
    return {
        "fad_generated_vs_style_corpus": round(
            frechet_distance(e_gen, e_a), 4),
        "fad_real_vs_real_floor": round(frechet_distance(e_b, e_a), 4),
        "fad_other_class_ceiling": round(frechet_distance(e_o, e_a), 4),
        "logmel_stats_distance_generated_vs_corpus": round(
            log_mel_stats_distance(generated, corpus_a), 6),
        "logmel_stats_distance_real_vs_real": round(
            log_mel_stats_distance(corpus_b, corpus_a), 6),
        "pairwise_spread_generated": round(pairwise_spread(generated), 4),
        "pairwise_spread_real": round(pairwise_spread(corpus_a), 4),
    }


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--pack", required=True)
    p.add_argument("--style-class", type=int, default=0,
                   help="pack class index to condition on")
    p.add_argument("--n", type=int, default=16,
                   help="generated samples (= per-corpus sample size)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--sampler", choices=["ddim", "dpm++"], default="ddim")
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument("--latent-stats", choices=["none", "corpus"],
                   default="none",
                   help="'corpus': draw z_T from the schedule's true "
                        "marginal q(z_T) under per-channel latent moments "
                        "of the style class (models.ldm.corpus_latent_stats"
                        ") instead of N(0, I)")
    p.add_argument("--raw-weights", action="store_true",
                   help="sample from the raw trained weights instead of "
                        "the checkpoint's EMA (measures EMA's effect)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.datasets.packed import (
        PackedSpectrogramDataset,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import (
        corpus_latent_stats, load_ldm, style_ddim_sample,
    )

    cfg = default_config()
    ldm = load_ldm(cfg, full_checkpoint=args.checkpoint,
                   use_ema=not args.raw_weights, device=dev)

    ds = PackedSpectrogramDataset(args.pack)
    labels = ds.labels()
    cls = int(args.style_class)
    cls_idx = np.flatnonzero(labels == cls)
    other_idx = np.flatnonzero(labels != cls)
    if len(cls_idx) < 3 * args.n:
        raise SystemExit(f"class {cls} has only {len(cls_idx)} items; "
                         f"need >= {3 * args.n}")
    rng = np.random.RandomState(args.seed)
    pick = rng.permutation(cls_idx)
    cond_idx, real_a, real_b = (pick[:args.n],
                                pick[args.n:2 * args.n],
                                pick[2 * args.n:3 * args.n])
    other = rng.permutation(other_idx)[:args.n]

    styles = ds.gather(cond_idx)[0]
    corpus_a = ds.gather(real_a)[0]       # disjoint real halves
    corpus_b = ds.gather(real_b)[0]
    mismatch = ds.gather(other)[0]
    name = (ds.classes[cls] if cls < len(ds.classes) else str(cls))
    print(f"class {cls} ({name}): {args.n} generated, sampler="
          f"{args.sampler}, steps={args.steps}, guidance={args.guidance}",
          flush=True)

    z_hw = cfg.model.image_size // 8
    latent_stats = None
    if args.latent_stats == "corpus":
        # moments of the conditioning styles only, not the eval halves
        latent_stats = corpus_latent_stats(ldm, styles)
    generated = style_ddim_sample(
        ldm, (args.n, z_hw, z_hw, cfg.model.latent_dim),
        torch.as_tensor(styles, device=dev), timesteps=args.steps,
        sampler=args.sampler, guidance=args.guidance,
        latent_stats=latent_stats, seed=args.seed)
    generated = generated.float().cpu().numpy()

    results = {
        "checkpoint": str(args.checkpoint),
        "style_class": cls, "class_name": name, "n": args.n,
        "steps": args.steps, "sampler": args.sampler,
        "guidance": args.guidance,
        "latent_stats": args.latent_stats,
        "weights": "raw" if args.raw_weights else "ema-preferred",
        **generation_metrics(generated, corpus_a, corpus_b, mismatch, dev),
        "eval_backend": dev.type,
    }
    print(json.dumps(results, indent=2), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2))
        print(f"wrote {out}", flush=True)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
