#!/usr/bin/env python3
"""Roofline of the batch-64 transfer path, on the port.

The port's counterpart of ``tools/roofline_b64.py``: the B=64, 50-step
SDEdit transfer split into its stages (style encoder, VAE encode, the
49-step DDIM scan, VAE decode, the whole transfer, the whole transfer
with bf16 I/O, kernel A), each timed on the card, its work counted, and
placed on the card's roofline, under the JAX record's stage names and
keys.

* Time: ``benchmarks.timed`` (CUDA events, best of 4 calls) around one
  call of a chain of dependent calls, less the sync floor, over the
  chain's length.  The small stages chain 768 calls, the others
  ``--chain`` (default 32), as the JAX tool does.
* Beside it, ``kernel_ms``: the card's kernel time in one call
  (``torch.profiler``), and ``idle_share`` = 1 - kernel_ms / ms: where
  the eager stages are host-bound the events include idle gaps.  A
  profile that lacks launches of kernels A or B made in the call (the
  profiler can drop some) records None for both.
* FLOPs: ``benchmarks._flops`` (``FlopCounterMode``) over one call,
  which counts every tap of a padded convolution and no elementwise
  work.  Kernel A is opaque to it, so the fused stage takes its own
  count (``ops/fused_sampler.py trajectory_cost``).
* Bytes: XLA's "bytes accessed" has no torch counterpart, so
  ``ByteCounter`` (a ``TorchDispatchMode``) sums the bytes of every aten
  op's tensor inputs and outputs over one call (views excluded).  Eager
  PyTorch runs those ops one by one, so the count is unfused and reads
  higher than XLA's fused count.  Kernel B's ctypes launches are not
  aten ops: each adds its own operands (the f32 latent read and written,
  the UNet's eps read); kernel A's stage is its packed operands and
  latents per launch.
* Roofline: bound = min(peak, intensity x HBM rate) from
  ``utils/chips.py``'s dense bf16 and HBM rates of the card;
  ``bound_by`` 'hbm' or 'compute'.

Kernel A packs at most 8 rows (the engine's largest fused bucket), so
the fused stage runs the 64 rows as 8 launches at B=8
(``launches``, ``batch_per_launch``), each block's operands packed once
before the chain.

    python tools/torch_roofline_b64.py [--batch 64] [--steps 50] \
        [--chain N] [--skip-fused] [--out runs/torch/roofline_b64.json]
    python tools/torch_roofline_b64.py --device cpu --batch 2 --steps 3 \
        --skip-fused

The record adds ``power_limit``, and per stage ``kernel_ms`` and
``idle_share`` (and the fused stage's ``launches`` and
``batch_per_launch``), to the JAX keys; stderr ends with the kernels'
launch line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tools.torch_common import (  # noqa: E402
    REPO, add_device_arg, chip_name, device_of, power_limit, print_launches,
)

EXTRA_KEYS = ("power_limit", "kernel_ms", "idle_share", "launches",
              "batch_per_launch")
# Chained calls of the small stages (each ~1 ms on the card), as in the
# JAX tool.
SMALL_CHAIN = 768
FUSED_CHAIN = 8


class ByteCounter(TorchDispatchMode):
    """Sums, over every aten op run inside it, the bytes of its tensor
    inputs and outputs (``numel * element_size``; ops that only make a
    view move none and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not getattr(func, "is_view", False):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def count_bytes(fn, *args, b_launch_bytes: int = 0) -> float:
    """Bytes of one call ``fn(*args)``: its aten ops' (``ByteCounter``)
    plus ``b_launch_bytes`` for each kernel B launch it makes."""
    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        fused_ddim_update,
    )
    b0 = fused_ddim_update.launches
    with ByteCounter() as counter:
        fn(*args)
    return float(counter.bytes
                 + (fused_ddim_update.launches - b0) * b_launch_bytes)


def kernel_seconds(fn) -> float | None:
    """The card's kernel time in one call of fn (``torch.profiler``, no
    trace written), seconds; None when the profile lacks launches of the
    port's own kernels that the call made (their wrappers' counts against
    the kernels the profile names), since its sum would then be short."""
    from torch.profiler import ProfilerActivity, profile

    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        fused_ddim_update,
    )
    from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
        fused_ddim_sample,
    )
    own = {"fused_sampler_kernel": fused_ddim_sample,
           "ddim_update_": fused_ddim_update}
    before = {name: w.launches for name, w in own.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = 0.0
    seen = dict.fromkeys(own, 0)
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue
        if getattr(evt, "is_user_annotation", False):
            continue
        us += getattr(evt, "self_device_time_total",
                      getattr(evt, "self_cuda_time_total", 0.0))
        for name in own:
            if name in evt.key:
                seen[name] += evt.count
    made = {name: w.launches - before[name] for name, w in own.items()}
    if any(seen[name] < made[name] for name in own):
        print(f"the profile holds {seen} of the launches made {made}: no "
              "kernel time recorded", file=sys.stderr, flush=True)
        return None
    return us / 1e6


def roofline_entry(seconds: float, flops, nbytes, peak, bw,
                   kernel_s=None) -> dict:
    """One stage's record (the JAX keys, then ``kernel_ms`` and
    ``idle_share``)."""
    fl, by = flops, nbytes
    intensity = (fl / by) if (fl and by) else None
    achieved = (fl / seconds) if fl else None
    bound = None
    if intensity is not None and peak and bw:
        bound = min(peak, intensity * bw)
    return {
        "ms": round(seconds * 1000, 4),
        "gflop": fl and round(fl / 1e9, 3),
        "gb_accessed": by and round(by / 1e9, 4),
        "intensity_flop_per_byte": intensity and round(intensity, 2),
        "achieved_tflops": achieved and round(achieved / 1e12, 3),
        "mfu": (achieved and peak) and round(achieved / peak, 4),
        "roofline_bound_tflops": bound and round(bound / 1e12, 3),
        "pct_of_roofline": (achieved and bound) and round(
            achieved / bound, 3),
        "bound_by": (None if intensity is None or not peak or not bw
                     else ("hbm" if intensity * bw < peak else "compute")),
        "kernel_ms": None if kernel_s is None else round(kernel_s * 1000, 4),
        "idle_share": None if kernel_s is None else round(
            max(0.0, 1.0 - kernel_s / seconds), 4),
    }


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=str(REPO / "runs" / "torch"
                                        / "roofline_b64.json"))
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--chain", type=int, default=0,
                   help="dependent-call chain length (0 = auto)")
    p.add_argument("--skip-fused", action="store_true",
                   help="skip the fused-kernel stage (its plain version "
                        "on the CPU is slow at large batch)")
    add_device_arg(p)
    args = p.parse_args(argv)
    dev = device_of(args)

    from music_style_transfer_ldm_tpu_torch.benchmarks import _flops, timed
    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
        transfer_time_grid,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import (
        _nchw, _run_sampler, build_ldm, content_style_transfer,
    )
    from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
        FUSED_MAX_BATCH, fused_ddim_sample, pack_operands, trajectory_cost,
    )
    from music_style_transfer_ldm_tpu_torch.utils.chips import (
        hbm_bytes_per_sec, peak_flops_per_sec,
    )

    on_cpu = dev.type == "cpu"
    kind = chip_name(dev)
    peak = peak_flops_per_sec(kind)
    bw = hbm_bytes_per_sec(kind)
    if not on_cpu and not (peak and bw):
        raise SystemExit(f"no peak rates for {kind!r} in utils/chips.py")
    print(f"device: {kind} peak={peak and peak / 1e12} TF/s "
          f"bw={bw and bw / 1e9} GB/s", flush=True)

    cfg = default_config()
    ldm = build_ldm(cfg, dtype=torch.bfloat16, device=dev, seed=0)
    B, S = args.batch, cfg.model.image_size
    rng = np.random.RandomState(0)
    content = torch.as_tensor(rng.rand(B, S, S, 1).astype(np.float32),
                              device=dev)
    style = torch.as_tensor(rng.rand(B, S, S, 1).astype(np.float32),
                            device=dev)

    n_chain = args.chain or (2 if on_cpu else 32)
    steps = args.steps
    times_grid = transfer_time_grid(steps)

    floor_s, _ = timed(lambda a: a.sum(), content, repeats=10, warmup=25,
                       device=dev)
    print(f"sync floor {floor_s * 1000:.4f} ms", flush=True)

    record: dict = {
        "batch": B, "steps": steps, "chip": kind,
        "power_limit": power_limit(dev),
        "peak_tflops": peak and round(peak / 1e12, 1),
        "hbm_gb_s": bw and round(bw / 1e9), "chain": n_chain,
        "sync_floor_ms": round(floor_s * 1000, 4),
        "methodology": (
            "per-stage device time = CUDA events around one call of a "
            "chain of dependent calls (best of 4), minus the sync floor, "
            "/ chain; kernel_ms = torch.profiler kernel time of one "
            "call, idle_share = 1 - kernel_ms / ms; flops "
            "= FlopCounterMode over one call (every padded tap, no "
            "elementwise work; kernel A: trajectory_cost); bytes = the "
            "tensor inputs and outputs of every aten op over one call "
            "(unfused, so above XLA's fused count) plus kernel B's "
            "operands per launch (kernel A: its packed operands and "
            "latents per launch); roofline bound = min(peak, intensity * "
            "HBM bw), the card's dense bf16 and HBM rates"),
        "stages": {},
    }

    z_elems = B * (S // 8) * (S // 8) * cfg.model.latent_dim
    # kernel B: the f32 latent read and written, the bf16 eps read
    b_launch_bytes = z_elems * (4 + 2 + 4)

    def stage(name: str, chained_fn, single_fn, single_args,
              chain: int | None = None, flops=None, nbytes=None,
              extra: dict | None = None) -> None:
        """Time ``chained_fn(x, n)`` (n dependent calls); count the work
        of one ``single_fn(*single_args)`` unless given."""
        n = n_chain if chain is None else (2 if on_cpu else chain)
        fl = flops if flops is not None else _flops(single_fn, *single_args)
        by = nbytes if nbytes is not None else count_bytes(
            single_fn, *single_args, b_launch_bytes=b_launch_bytes)

        t_stage = time.perf_counter()

        def chained(x):
            return chained_fn(x, n)
        t_chain, _ = timed(chained, single_args[0], repeats=4, device=dev)
        t = max(t_chain - floor_s, 1e-9) / n
        kernel_s = None if on_cpu else kernel_seconds(
            lambda: single_fn(*single_args))
        entry = roofline_entry(t, fl, by, peak, bw, kernel_s)
        entry.update(extra or {})
        record["stages"][name] = entry
        print(f"{name}: {entry} ({time.perf_counter() - t_stage:.1f} s "
              "timing it)", flush=True)

    # ---- stage: style encoder ------------------------------------------
    def style_embed_once(s):
        return ldm.style_embed(s)

    def style_embed_chain(s, n):
        for _ in range(n):
            emb = style_embed_once(s)
            # a real dependency: a tiny slice of the output folded back
            s = s + emb["s6"].float().mean() * 1e-12
        return s

    stage("style_encoder", style_embed_chain, style_embed_once, (style,),
          chain=SMALL_CHAIN)

    # ---- stage: VAE encode ----------------------------------------------
    def encode_once(c):
        return ldm.encode(c)

    def encode_chain(c, n):
        for _ in range(n):
            c = c + encode_once(c).float().mean() * 1e-12
        return c

    stage("vae_encode", encode_chain, encode_once, (content,),
          chain=SMALL_CHAIN)

    # ---- stage: the 49-step DDIM scan (denoiser walk only) ---------------
    emb = style_embed_once(style)
    emb_nchw = {k: _nchw(v) for k, v in emb.items()}
    z0 = torch.as_tensor(rng.rand(B, S // 8, S // 8, cfg.model.latent_dim)
                         .astype(np.float32), device=dev)

    def scan_once(z):
        out = _run_sampler("ddim", ldm, emb_nchw, 1.0, _nchw(z), times_grid,
                           0.0)
        return out.permute(0, 2, 3, 1)

    def scan_chain(z, n):
        for _ in range(n):
            z = scan_once(z)
        return z

    stage("ddim_scan_49", scan_chain, scan_once, (z0,))

    # ---- stage: VAE decode ------------------------------------------------
    def decode_once(z):
        return ldm.decode(z)

    def decode_chain(z, n):
        for _ in range(n):
            z = z + decode_once(z).float().mean() * 1e-12
        return z

    stage("vae_decode", decode_chain, decode_once, (z0,), chain=SMALL_CHAIN)

    # ---- whole path (the bench's transfer_b64) ---------------------------
    def transfer_once(c):
        return content_style_transfer(ldm, c, style, num_timesteps=steps,
                                      eta=0.0, seeds=2)[0]

    def transfer_chain(c, n):
        for _ in range(n):
            c = transfer_once(c)
        return c

    stage("full_transfer", transfer_chain, transfer_once, (content,))

    # ---- candidate: bf16 inputs end-to-end --------------------------------
    content16 = content.to(torch.bfloat16)

    def transfer_bf16_once(c):
        return content_style_transfer(ldm, c.float(), style,
                                      num_timesteps=steps, eta=0.0,
                                      seeds=2)[0].to(torch.bfloat16)

    def transfer_bf16_chain(c, n):
        for _ in range(n):
            c = transfer_bf16_once(c)
        return c

    stage("full_transfer_bf16_io", transfer_bf16_chain, transfer_bf16_once,
          (content16,))

    # ---- kernel A at b64: launches of the engine's largest bucket --------
    if args.skip_fused:
        record["stages"]["fused_kernel_b64"] = {"skipped": "--skip-fused"}
    else:
        per = min(B, FUSED_MAX_BATCH)
        if B % per:
            raise SystemExit(f"--batch {B} is not a multiple of kernel A's "
                             f"batch {per}")
        blocks = [slice(i, i + per) for i in range(0, B, per)]
        packs = [pack_operands(ldm.unet, {k: v[rows] for k, v in emb.items()},
                               ldm.schedule, times_grid, 0.0, batch=per)
                 for rows in blocks]
        n_steps = len(times_grid) - 1
        costs = [trajectory_cost(ops, n_steps) for ops in packs]

        def fused_once(z):
            return torch.cat([fused_ddim_sample(ops, z[rows], n_steps)
                              for ops, rows in zip(packs, blocks)])

        def fused_chain(z, n):
            for _ in range(n):
                z = fused_once(z)
            return z

        stage("fused_kernel_b64", fused_chain, fused_once, (z0,),
              chain=FUSED_CHAIN,
              flops=float(sum(c["flops"] for c in costs)),
              nbytes=float(sum(c["bytes"] for c in costs)),
              extra={"launches": len(blocks), "batch_per_launch": per})

    stages = record["stages"]
    known = [k for k in ("style_encoder", "vae_encode", "ddim_scan_49",
                         "vae_decode") if stages.get(k, {}).get("ms")]
    record["stage_sum_ms"] = round(sum(stages[k]["ms"] for k in known), 4)
    record["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())
    record["backend"] = dev.type

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=1) + "\n")
    print(f"wrote {out}", flush=True)
    print_launches()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
