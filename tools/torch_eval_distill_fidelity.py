#!/usr/bin/env python3
"""Teacher-output fidelity of few-step transfer, on the port: what
distillation buys.

The port's counterpart of ``tools/eval_distill_fidelity.py``, under its
JSON keys: on held-out pairs, the pixel MSE and PSNR against the
teacher's full-grid (``--steps``) transfer output, for the teacher on
the coarse grid (``--sample-steps``) and for the distilled student on
the same grid.  All three see the same noise: pair i draws from seed i
on every run.

The teacher runs the scan DDIM (kernel B each step).  A student that
carries ``distill`` metadata samples as ``cli transfer --sampler fused``
runs it: kernel A, in groups of ``fused_bucket_max()`` pairs; a stock
checkpoint given as the student takes the scan route like the teacher.

    python tools/torch_eval_distill_fidelity.py \
        --teacher runs/ldm/ldm_final.pt --student runs/distill/distilled_6.pt \
        --sample-steps 7 --pack train.spk --pairings pairings.csv \
        [--out F.json] [--device cpu]

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
    add_device_arg, device_of, held_out_pairs, print_launches,
)


def fidelity(x: np.ndarray, ref: np.ndarray) -> dict:
    """MSE against the teacher's full-grid output, and its PSNR (dB, peak
    1)."""
    mse = float(np.mean((x - ref) ** 2))
    return {"mse_vs_teacher50": round(mse, 6),
            "psnr_db": round(float(10 * np.log10(1.0 / max(mse, 1e-12))),
                             2)}


def mse_reduction_pct(results: dict) -> float:
    return round(
        100.0 * (1.0 - results["student_distilled"]["mse_vs_teacher50"]
                 / max(results["teacher_coarse"]["mse_vs_teacher50"],
                       1e-12)), 1)


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--teacher", required=True)
    p.add_argument("--student", required=True)
    p.add_argument("--sample-steps", type=int, required=True,
                   help="coarse grid points (distilled steps + 1)")
    p.add_argument("--pack", required=True)
    p.add_argument("--pairings", required=True)
    p.add_argument("--n-pairs", type=int, default=16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default=None)
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.models.ldm import (
        checkpoint_distill_meta, content_style_transfer, load_ldm,
    )
    from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
        fused_content_style_transfer,
    )
    from music_style_transfer_ldm_tpu_torch.utils.chips import (
        fused_bucket_max,
    )

    cfg = default_config()
    teacher = load_ldm(cfg, full_checkpoint=args.teacher, device=dev)
    student = load_ldm(cfg, full_checkpoint=args.student, device=dev)
    student_fused = checkpoint_distill_meta(args.student) is not None

    content, style = held_out_pairs(args.pack, args.pairings, args.n_pairs)
    content = torch.as_tensor(content, device=dev)
    style = torch.as_tensor(style, device=dev)
    seeds = np.arange(len(content))

    def run(ldm, sample_steps, fused=False):
        if not fused:
            return content_style_transfer(
                ldm, content, style, num_timesteps=args.steps,
                sampler="ddim", steps=sample_steps,
                seeds=seeds)[0].float().cpu().numpy()
        cap = fused_bucket_max()
        return torch.cat([fused_content_style_transfer(
            ldm, content[lo:lo + cap], style[lo:lo + cap],
            num_timesteps=args.steps, sampler="ddim", steps=sample_steps,
            seeds=seeds[lo:lo + cap])
            for lo in range(0, len(content), cap)]).float().cpu().numpy()

    ref = run(teacher, None)                     # teacher, full grid
    coarse_teacher = run(teacher, args.sample_steps)
    coarse_student = run(student, args.sample_steps, student_fused)

    results = {
        "n_pairs": len(content), "steps": args.steps,
        "sample_steps": args.sample_steps,
        "teacher_coarse": fidelity(coarse_teacher, ref),
        "student_distilled": fidelity(coarse_student, ref),
        "teacher": args.teacher, "student": args.student,
        "eval_backend": dev.type,
    }
    results["mse_reduction_pct"] = mse_reduction_pct(results)
    print(json.dumps(results, indent=2), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=2) + "\n")
    print_launches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
