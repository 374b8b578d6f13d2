#!/usr/bin/env python3
"""The PyTorch port's check on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card is required (there is no CPU path);
  2. build: nvcc compiles the fused-trajectory kernel (CUDA C++, sm_90a)
     while Triton compiles the DDIM update kernel;
  3. every kernel against its plain PyTorch version at the main path's
     shapes, with the tolerances stated below;
  4. the main path: SDEdit transfer served by the InferenceEngine at full
     width (random weights from seed 0, bf16), on the fused route and the
     scan route, with the kernels' launch counts read around it;
  5. times with CUDA events, each printed with the card's name and power
     limit.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

TOL_KERNEL_B = 1e-6     # f32 elementwise, same op order, no fma contraction
TOL_KERNEL_A = 1e-4     # f32 latents after a full trajectory (sum order)
TOL_KERNEL_A_BF16 = 2e-2  # bf16 decoded images [0, 1] (rounding flips)
TOL_GROUPING = 1e-4     # f32 engine: one request alone vs inside a batch

H100_BF16_FLOPS = 989e12   # dense, tensor cores
H100_F32_FLOPS = 67e12     # outside the tensor cores
H100_BYTES = 3.35e12       # HBM3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the measurements here (JSON)")
    args = ap.parse_args()

    # ---- 1. device ----------------------------------------------------
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check runs on a GPU",
              file=sys.stderr)
        return 2
    import numpy as np
    from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
        ddim_sample, transfer_time_grid,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        ddim_update_reference, fused_ddim_update,
    )
    from music_style_transfer_ldm_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind}; capability {torch.cuda.get_device_capability()};"
          f" torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    check(torch.cuda.get_device_capability() == (9, 0),
          "the fused sampler is built for sm_90a (Hopper)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("parity phases: cudnn.allow_tf32=False, "
          "cuda.matmul.allow_tf32=False")
    results: dict = {"card": smi, "kind": kind}

    # ---- 2. build (nvcc and Triton at once) ----------------------------
    built: dict = {}

    def nvcc_build():
        try:
            built.update(fs.build_fused_sampler())
        except Exception as e:  # noqa: BLE001 — reported below
            built["error"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=nvcc_build)
    th.start()
    probe = torch.zeros(8, 16, 16, 32, device=dev)
    fused_ddim_update(probe, probe, 0.5, 0.6, 0.0)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    th.join()
    if "error" in built:
        fail(f"kernel A build: {built['error']}")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())
    print(f"build: nvcc {built['seconds']:.1f} s (kernel A), Triton JIT "
          f"{triton_s:.1f} s (kernel B)")
    results["build_s"] = {"nvcc": built["seconds"], "triton": triton_s}

    # ---- 3. kernels against their plain versions -----------------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ldm32 = build_ldm(dtype=torch.float32, device=dev, seed=0)
    ab = ldm32.schedule.alpha_bars_np
    x = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    e = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    err_b = 0.0
    for t, eta in ((49, 0.0), (49, 0.5), (1, 0.0)):
        k = fused_ddim_update(x, e, float(ab[t]), float(ab[t - 1]), eta)
        r = ddim_update_reference(x, e, float(ab[t]), float(ab[t - 1]), eta)
        torch.cuda.synchronize()
        err_b = max(err_b, (k - r).abs().max().item())
    print(f"kernel B vs plain [8,16,16,32] f32: max abs err {err_b:.3g} "
          f"(tol {TOL_KERNEL_B})")
    check(err_b <= TOL_KERNEL_B, "kernel B disagrees with its plain version")

    content = torch.rand(8, 128, 128, 1, device=dev, generator=g)
    style = torch.rand(8, 128, 128, 1, device=dev, generator=g)

    def packed(ldm, B, sampler="ddim", eta=0.0, steps=None):
        times = transfer_time_grid(50, steps)
        z_t = ldm.noised_latents(content[:B], 50, seeds=np.arange(B))
        ops = fs.pack_operands(ldm.unet, ldm.style_embed(style[:B]),
                               ldm.schedule, times, eta, sampler=sampler,
                               batch=B)
        return ops, z_t.permute(0, 2, 3, 1).contiguous(), len(times) - 1

    err_a = 0.0
    for B, sampler, eta, steps in ((1, "ddim", 0.0, None),
                                   (1, "ddim", 0.5, None),
                                   (4, "ddim", 0.0, None),
                                   (4, "ddim", 0.5, None),
                                   (4, "dpm++", 0.0, 25)):
        ops, z_t, n = packed(ldm32, B, sampler, eta, steps)
        k = fs.fused_ddim_sample(ops, z_t, n)
        r = fs.reference_ddim_sample(ops, z_t, n)
        torch.cuda.synchronize()
        err = (k - r).abs().max().item()
        check(bool(torch.isfinite(k).all()), "kernel A gave non-finite")
        print(f"kernel A vs plain f32 B={B} {sampler} eta={eta} steps={n}: "
              f"max abs err {err:.3g} on latents (tol {TOL_KERNEL_A})")
        err_a = max(err_a, err)
    check(err_a <= TOL_KERNEL_A, "kernel A (f32) disagrees with its plain "
          "version")

    ldm = build_ldm(dtype=torch.bfloat16, device=dev, seed=0)
    ops16, z_t16, n16 = packed(ldm, 4)
    k = fs.fused_ddim_sample(ops16, z_t16, n16)
    r = fs.reference_ddim_sample(ops16, z_t16, n16)
    dk = ldm.decode_unit(k.permute(0, 3, 1, 2))
    dr = ldm.decode_unit(r.permute(0, 3, 1, 2))
    torch.cuda.synchronize()
    err_a16 = (dk - dr).abs().max().item()
    print(f"kernel A vs plain bf16 B=4 ddim steps={n16}: max abs err "
          f"{err_a16:.3g} on decoded images, {(k - r).abs().max().item():.3g}"
          f" on latents (tol {TOL_KERNEL_A_BF16} decoded)")
    check(err_a16 <= TOL_KERNEL_A_BF16, "kernel A (bf16) disagrees with its "
          "plain version")
    results["max_abs_err"] = {"ddim_update": err_b, "fused_ddim_sample_f32":
                              err_a, "fused_ddim_sample_bf16_decoded":
                              err_a16}

    # ---- 4. the main path ---------------------------------------------
    rng = np.random.RandomState(0)
    reqs_c = rng.rand(8, 128, 128, 1).astype(np.float32)
    reqs_s = rng.rand(8, 128, 128, 1).astype(np.float32)
    engine = InferenceEngine(ldm, EngineConfig(sampler="fused"))
    fs.fused_ddim_sample.launches = 0
    fused_ddim_update.launches = 0
    t0 = time.perf_counter()
    engine.warmup()
    warm_s = time.perf_counter() - t0
    outs = [engine.transfer_batch(reqs_c[:1], reqs_s[:1], seeds=[11]),
            engine.transfer_batch(reqs_c[:3], reqs_s[:3], seeds=[11, 12, 13]),
            engine.transfer_batch(reqs_c, reqs_s, seeds=np.arange(8))]
    engine.start()
    waiters = [engine.submit(reqs_c[i], reqs_s[i], seed=100 + i)
               for i in range(6)]
    served = [w.get(timeout=600) for w in waiters]
    engine.stop()
    torch.cuda.synchronize()
    launches = {"fused_ddim_sample": fs.fused_ddim_sample.launches,
                "ddim_update": fused_ddim_update.launches}
    print(f"main path: warmup {warm_s:.2f} s; served B=1, B=3 (bucket 4), "
          f"B=8 and 6 submitted requests; launches {launches}; stats "
          f"{engine.stats()}")
    for r in served:
        check(not isinstance(r, Exception), f"request failed: {r!r}")
    for o in outs:
        img, audio = o["image"], o["audio"]
        check(bool(np.isfinite(img).all()) and img.min() >= 0.0
              and img.max() <= 1.0, "images must be finite in [0, 1]")
        check(audio.shape[1:] == (66150,) and bool(np.isfinite(audio).all()),
              f"audio shape {audio.shape}")
    for r in served:
        check(r["image"].shape == (128, 128, 1)
              and r["audio"].shape == (66150,)
              and bool(np.isfinite(r["audio"]).all()), "served output")
    check(launches["fused_ddim_sample"] > 0, "kernel A never ran on the "
          "main path")
    check(launches["ddim_update"] > 0, "kernel B never ran on the main path")
    results["launches"] = launches

    eng32 = InferenceEngine(ldm32, EngineConfig(
        sampler="fused", invert_audio=False, batch_buckets=(1, 4)))
    alone = eng32.transfer_batch(reqs_c[1:2], reqs_s[1:2], seeds=[12])
    inside = eng32.transfer_batch(reqs_c[:3], reqs_s[:3],
                                  seeds=[11, 12, 13])
    err_g = float(np.abs(alone["image"][0] - inside["image"][1]).max())
    print(f"grouping (f32 engine, fused route): alone vs in a batch of 3: "
          f"max abs err {err_g:.3g} (tol {TOL_GROUPING})")
    check(err_g <= TOL_GROUPING, "a request's image depends on its batch")

    # ---- 5. times -------------------------------------------------------
    def cuda_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    times: dict = {"kernel_a_ms": {}, "plain_a_ms": {}, "scan_route_ms": {},
                   "bound_a_ms": {}, "engine_request_s": {}}
    for B in (1, 4, 8):
        ops, z_t, n = packed(ldm, B)
        emb = ldm.style_encoder(style[:B].permute(0, 3, 1, 2).bfloat16())
        z_nchw = z_t.permute(0, 3, 1, 2)
        grid = transfer_time_grid(50)
        times["kernel_a_ms"][B] = cuda_ms(
            lambda: fs.fused_ddim_sample(ops, z_t, n), 5)
        times["plain_a_ms"][B] = cuda_ms(
            lambda: fs.reference_ddim_sample(ops, z_t, n), 2)
        times["scan_route_ms"][B] = cuda_ms(
            lambda: ddim_sample(lambda z, t: ldm.unet(z, t, emb).float(),
                                ldm.schedule, z_nchw, grid), 3)
        cost = fs.trajectory_cost(ops, n)
        times["bound_a_ms"][B] = 1e3 * max(cost["flops"] / H100_BF16_FLOPS,
                                           cost["bytes"] / H100_BYTES)
        print(f"time {card} B={B}, {n} steps, bf16: kernel A "
              f"{times['kernel_a_ms'][B]:.3f} ms/trajectory, plain version "
              f"{times['plain_a_ms'][B]:.3f} ms, scan route "
              f"{times['scan_route_ms'][B]:.3f} ms, bound "
              f"{times['bound_a_ms'][B]:.4f} ms ({cost['flops'] / 1e9:.2f} "
              f"GFLOP, {cost['bytes'] / 1e6:.2f} MB)")
    ab49, ab48 = float(ab[49]), float(ab[48])
    xb = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    eb = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    kb_ms = cuda_ms(lambda: fused_ddim_update(xb, eb, ab49, ab48, 0.0), 200)
    pb_ms = cuda_ms(lambda: ddim_update_reference(xb, eb, ab49, ab48, 0.0),
                    200)
    nb = xb.numel()
    bound_b_ms = 1e3 * max(3 * 4 * nb / H100_BYTES, 6 * nb / H100_F32_FLOPS)
    print(f"time {card} kernel B [8,16,16,32] f32: {kb_ms * 1e3:.2f} us/launch"
          f", plain version {pb_ms * 1e3:.2f} us, bound {bound_b_ms * 1e3:.3f}"
          " us (bytes)")
    for B in engine.config.batch_buckets:
        t0 = time.perf_counter()
        engine.transfer_batch(reqs_c[:B], reqs_s[:B], seeds=np.arange(B))
        times["engine_request_s"][B] = time.perf_counter() - t0
        route = "fused" if engine.uses_fused(B) else "scan"
        print(f"time {card} engine transfer_batch B={B} ({route} route, 50 "
              f"steps, NNLS 64, GL 32): {times['engine_request_s'][B]:.3f} s")
    mem = torch.cuda.max_memory_allocated() / 2**20
    print(f"memory {card} max_memory_allocated {mem:.1f} MiB")
    times.update({"kernel_b_ms": kb_ms, "plain_b_ms": pb_ms,
                  "bound_b_ms": bound_b_ms, "max_memory_mib": mem})
    results["times"] = times

    kernels = [
        {"name": "fused_ddim_sample", "route": "cuda",
         "source": "music_style_transfer_ldm_tpu_torch/csrc/fused_sampler.cu",
         "replaces": "music_style_transfer_ldm_tpu/ops/pallas/"
                     "fused_sampler.py:522",
         "launches": launches["fused_ddim_sample"], "max_abs_err": err_a,
         "ms": times["kernel_a_ms"][1], "plain_ms": times["plain_a_ms"][1],
         "bound_ms": times["bound_a_ms"][1], "bound_by": "operations",
         "library_ms": None},
        {"name": "fused_ddim_update", "route": "triton",
         "source": "music_style_transfer_ldm_tpu_torch/ops/ddim_update.py",
         "replaces": "music_style_transfer_ldm_tpu/ops/pallas/"
                     "ddim_update.py:52",
         "launches": launches["ddim_update"], "max_abs_err": err_b,
         "ms": kb_ms, "plain_ms": pb_ms, "bound_ms": bound_b_ms,
         "bound_by": "bytes", "library_ms": None},
    ]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**results, "kernels": kernels}, f, indent=1)
    print("library call: none (no single PyTorch call computes either "
          "function); kernel A's B=1 time, scan route beside it above")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
