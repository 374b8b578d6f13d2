#!/usr/bin/env python3
"""The PyTorch port's check on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card is required (there is no CPU path);
  2. build: nvcc compiles the fused-trajectory kernel (A) and the mel
     front-end kernel (C), both CUDA C++ for sm_90a, in parallel, while
     Triton compiles the DDIM update kernel (B);
  3. every kernel against its plain PyTorch version at the main path's
     shapes, with the tolerances stated below;
  4. the image-level path: SDEdit transfer served by the InferenceEngine
     at full width (random weights from seed 0, bf16), on the fused route
     and the scan route, with the kernels' launch counts read around it;
  5. the WAV path, as a user runs it: a port checkpoint of the same
     weights, ``cli transfer`` (a 9 s 44.1 kHz stereo WAV -> PNG + WAV,
     fused sampler, 100 steps, overlap 0.5, content phases), ``cli
     generate``, and the HTTP server on an ephemeral localhost port
     answering /v1/transfer (WAV content) and /v1/generate, with the
     launch counts of all three kernels read around it;
  6. times with CUDA events (host clock for the CLI and HTTP), each
     printed with the card's name and power limit.
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

TOL_KERNEL_B = 1e-6     # f32 elementwise, same op order, no fma contraction
TOL_KERNEL_A = 1e-4     # f32 latents after a full trajectory (sum order)
TOL_KERNEL_A_BF16 = 2e-2  # bf16 decoded images [0, 1] (rounding flips)
TOL_GROUPING = 1e-4     # f32 engine: one request alone vs inside a batch
# Kernel C vs its plain version: summation order and log10f's last bit
# may move a value by one step of the /255 grid, on few elements.
TOL_KERNEL_C = 1.0 / 255.0 + 1e-6
TOL_KERNEL_C_FLIPS = 1e-3   # share of elements one grid step apart
TOL_GRID = 1e-4             # |255 x - round(255 x)| of every output

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
    from scipy.io import wavfile

    from music_style_transfer_ldm_tpu_torch import cli
    from music_style_transfer_ldm_tpu_torch.audio.mel import (
        mel_filterbank_np, power_spectrum,
    )
    from music_style_transfer_ldm_tpu_torch.audio.processor import (
        AudioProcessor,
    )
    from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
        ddim_sample, transfer_time_grid,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.ops import fused_mel_image as fm
    from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        ddim_update_reference, fused_ddim_update,
    )
    from music_style_transfer_ldm_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine,
    )
    from music_style_transfer_ldm_tpu_torch.serving.server import serve
    from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
        save_checkpoint,
    )
    from music_style_transfer_ldm_tpu_torch.utils.png import read_png_gray

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

    # ---- 2. build (one nvcc per source and Triton, all at once) ---------
    built: dict = {"A": {}, "C": {}}

    def nvcc_build(key, fn):
        try:
            built[key].update(fn())
        except Exception as e:  # noqa: BLE001 — reported below
            built[key]["error"] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=nvcc_build, args=a) for a in (
        ("A", fs.build_fused_sampler), ("C", fm.build_fused_mel_image))]
    for th in threads:
        th.start()
    probe = torch.zeros(8, 16, 16, 32, device=dev)
    fused_ddim_update(probe, probe, 0.5, 0.6, 0.0)
    torch.cuda.synchronize()
    triton_s = time.perf_counter() - t0
    for th in threads:
        th.join()
    for key in ("A", "C"):
        if "error" in built[key]:
            fail(f"kernel {key} build: {built[key]['error']}")
        for line in built[key]["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas ({key}):", line.strip())
    print(f"build: nvcc {built['A']['seconds']:.1f} s (kernel A) and "
          f"{built['C']['seconds']:.1f} s (kernel C) in parallel, Triton "
          f"JIT {triton_s:.1f} s (kernel B)")
    results["build_s"] = {"nvcc_a": built["A"]["seconds"],
                          "nvcc_c": built["C"]["seconds"],
                          "triton": triton_s}

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
    fb = torch.as_tensor(mel_filterbank_np(22050, 2048, 128), device=dev)
    spectra = {}
    for B in (1, 8):
        waves = 0.3 * torch.randn(B, 66150, device=dev, generator=g)
        spectra[("waveform", B)] = power_spectrum(waves)
        scales = torch.logspace(-6, 4, B, device=dev)  # B=1: 1e-6
        spectra[("randn", B)] = (torch.randn(
            B, 1025, 130, device=dev, generator=g) ** 2
            * scales[:, None, None])
    err_c, flips_c = 0.0, 0.0
    for (kind_c, B), S in spectra.items():
        k = fm.fused_mel_unit_image(fb, S)
        r = fm.fused_mel_unit_image_reference(fb, S)
        torch.cuda.synchronize()
        d = (k - r).abs()
        err = d.max().item()
        flips = (d > 0.5 / 255.0).float().mean().item()
        off_grid = (k * 255.0 - torch.round(k * 255.0)).abs().max().item()
        check(tuple(k.shape) == (B, 128, 130), f"kernel C shape {k.shape}")
        print(f"kernel C vs plain [{B},1025,130] {kind_c}: max abs err "
              f"{err:.3g} (tol {TOL_KERNEL_C:.6g}), one-step flips "
              f"{flips:.3g} (tol {TOL_KERNEL_C_FLIPS}), off grid "
              f"{off_grid:.3g} (tol {TOL_GRID})")
        check(off_grid <= TOL_GRID, "kernel C output off the /255 grid")
        check(flips <= TOL_KERNEL_C_FLIPS, "kernel C flips too many values")
        err_c, flips_c = max(err_c, err), max(flips_c, flips)
    check(err_c <= TOL_KERNEL_C, "kernel C disagrees with its plain version")
    results["max_abs_err"] = {"ddim_update": err_b, "fused_ddim_sample_f32":
                              err_a, "fused_ddim_sample_bf16_decoded":
                              err_a16, "fused_mel_unit_image": err_c,
                              "fused_mel_unit_image_flip_share": flips_c}

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counted}

    counted = (fs.fused_ddim_sample, fused_ddim_update,
               fm.fused_mel_unit_image)

    # ---- 4. the image-level path --------------------------------------
    rng = np.random.RandomState(0)
    reqs_c = rng.rand(8, 128, 128, 1).astype(np.float32)
    reqs_s = rng.rand(8, 128, 128, 1).astype(np.float32)
    engine = InferenceEngine(ldm, EngineConfig(sampler="fused"))
    reset_counts()
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
    launches = read_counts()
    print(f"image path: warmup {warm_s:.2f} s; served B=1, B=3 (bucket 4), "
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
          "image path")
    check(launches["fused_ddim_update"] > 0, "kernel B never ran on the "
          "image path")
    results["launches"] = {"image_path": launches}

    eng32 = InferenceEngine(ldm32, EngineConfig(
        sampler="fused", invert_audio=False, batch_buckets=(1, 4)))
    alone = eng32.transfer_batch(reqs_c[1:2], reqs_s[1:2], seeds=[12])
    inside = eng32.transfer_batch(reqs_c[:3], reqs_s[:3],
                                  seeds=[11, 12, 13])
    err_g = float(np.abs(alone["image"][0] - inside["image"][1]).max())
    print(f"grouping (f32 engine, fused route): alone vs in a batch of 3: "
          f"max abs err {err_g:.3g} (tol {TOL_GROUPING})")
    check(err_g <= TOL_GROUPING, "a request's image depends on its batch")

    # ---- 5. the WAV path: CLI transfer and generate, HTTP server ------
    work = Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "ldm_seed0.pt"
    save_checkpoint(ckpt, build_ldm(dtype=torch.float32, device=dev, seed=0))
    sr_in, hop = 44100, int(3 * 0.5 * 22050)
    wav_rng = np.random.RandomState(0)
    t = np.arange(9 * sr_in) / sr_in
    env = np.clip(np.minimum(t - 0.5, 8.5 - t) * 4.0, 0.0, 1.0)
    tones = [sum(0.2 * np.sin(2 * np.pi * f0 * h * t + wav_rng.rand() * 6.28)
                 / h for h in (1, 2, 3)) for f0 in (220.0, 277.2)]
    stereo = np.stack([(tn + 0.02 * wav_rng.randn(len(t))) * env
                       for tn in tones], axis=1)
    content_wav = work / "content_44k_stereo.wav"
    wavfile.write(content_wav, sr_in, (stereo * 32767).astype(np.int16))
    ap = AudioProcessor(device=dev)
    trimmed = ap.trim_silence(ap.load_audio(content_wav)[0])
    n_chunks = len(range(0, len(trimmed), hop))

    reset_counts()
    t0 = time.perf_counter()
    cli.main(["transfer", "--checkpoint", str(ckpt), "--content",
              str(content_wav), "--style", str(content_wav), "--sampler",
              "fused", "--steps", "100", "--overlap", "0.5",
              "--phase-init", "content", "--output", str(work / "transfer")])
    torch.cuda.synchronize()
    cli_transfer_s = time.perf_counter() - t0
    cli.main(["generate", "--checkpoint", str(ckpt), "--style",
              str(work / "transfer.png"), "--sampler", "fused",
              "--output", str(work / "generate")])
    for name, n_img in (("transfer", n_chunks), ("generate", 1)):
        png = read_png_gray((work / f"{name}.png").read_bytes())
        sr_out, audio = wavfile.read(work / f"{name}.wav")
        want = (n_img - 1) * hop + 66150 if name == "transfer" else 66150
        print(f"cli {name}: PNG {png.shape}, WAV {audio.shape[0]} samples "
              f"at {sr_out} Hz (want {want}), {n_img} chunk(s)")
        check(png.shape == (128, 128 * n_img), f"cli {name} PNG {png.shape}")
        check(sr_out == 22050 and audio.shape == (want,)
              and bool(np.isfinite(audio).all()), f"cli {name} WAV")
    serve_args = cli.build_parser().parse_args(
        ["serve", "--checkpoint", str(ckpt), "--sampler", "fused"])
    http_engine = cli.build_engines(serve_args)["default"]
    httpd = serve(http_engine, host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    wav_buf = io.BytesIO()
    wavfile.write(wav_buf, sr_in, (stereo[sr_in:4 * sr_in] * 32767)
                  .astype(np.int16))
    style_b64 = base64.b64encode(
        (work / "generate.png").read_bytes()).decode()
    bodies = {"transfer": {"content_wav_b64": base64.b64encode(
        wav_buf.getvalue()).decode(), "style_png_b64": style_b64, "seed": 3},
        "generate": {"style_png_b64": style_b64, "seed": 3}}
    http_s = {}
    try:
        for op in ("transfer", "transfer", "generate"):
            req = urllib.request.Request(
                f"{base}/v1/{op}", data=json.dumps(bodies[op]).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=600) as resp:
                status, body = resp.status, json.loads(resp.read())
            http_s.setdefault(op, []).append(time.perf_counter() - t0)
            png = read_png_gray(base64.b64decode(body["image_png_b64"]))
            sr_out, audio = wavfile.read(io.BytesIO(
                base64.b64decode(body["audio_wav_b64"])))
            check(status == 200 and png.shape == (128, 128)
                  and audio.shape == (66150,) and sr_out == 22050
                  and bool(np.isfinite(audio).all()), f"HTTP /v1/{op}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        http_engine.stop()
    wav_launches = read_counts()
    print(f"WAV path: cli transfer {cli_transfer_s:.2f} s, HTTP 200 on "
          f"/v1/transfer x2 and /v1/generate; launches {wav_launches}")
    for fn in counted:
        check(wav_launches[fn.__name__] > 0,
              f"{fn.__name__} never ran on the WAV path")
    results["launches"]["wav_path"] = wav_launches

    # ---- 6. times -------------------------------------------------------
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
    times.update({"kernel_c_ms": {}, "plain_c_ms": {}, "bound_c_ms": {},
                  "front_end_ms_per_chunk": {}, "bound_c_by": {}})
    for B in (1, 8):
        S = spectra[("waveform", B)]
        times["kernel_c_ms"][B] = cuda_ms(
            lambda: fm.fused_mel_unit_image(fb, S), 50)
        times["plain_c_ms"][B] = cuda_ms(
            lambda: fm.fused_mel_unit_image_reference(fb, S), 50)
        cost = fm.mel_image_cost(128, 1025, 130, B)
        bound = {"operations": cost["flops"] / H100_F32_FLOPS,
                 "bytes": cost["bytes"] / H100_BYTES}
        times["bound_c_ms"][B] = 1e3 * max(bound.values())
        bound_c_by = times["bound_c_by"][B] = max(bound, key=bound.get)
        chunks = 0.3 * torch.randn(B, 66150, device=dev, generator=g)
        times["front_end_ms_per_chunk"][B] = cuda_ms(
            lambda: ap.waveform_batch_to_unit_images(chunks), 50) / B
        print(f"time {card} kernel C [{B},1025,130] f32: "
              f"{times['kernel_c_ms'][B] * 1e3:.1f} us/launch, plain version "
              f"{times['plain_c_ms'][B] * 1e3:.1f} us, bound "
              f"{times['bound_c_ms'][B] * 1e3:.2f} us ({bound_c_by}: "
              f"{cost['flops'] / 1e6:.1f} MFLOP, {cost['bytes'] / 1e6:.2f} "
              f"MB); front end (STFT + kernel C) "
              f"{times['front_end_ms_per_chunk'][B] * 1e3:.1f} us per chunk")
    times["cli_transfer_s"] = cli_transfer_s
    times["http_s"] = http_s
    print(f"time {card} cli transfer, {content_wav.name} (9 s, {n_chunks} "
          f"chunks, fused, 100 steps, overlap 0.5, content phases): "
          f"{cli_transfer_s:.3f} s wall")
    print(f"time {card} HTTP /v1/transfer (3 s WAV content, fused, 50 "
          f"steps): {http_s['transfer'][0]:.3f} s first, "
          f"{http_s['transfer'][1]:.3f} s second; /v1/generate (scan DDIM, "
          f"50 steps): {http_s['generate'][0]:.3f} s")
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
         "launches": wav_launches["fused_ddim_sample"], "max_abs_err": err_a,
         "ms": times["kernel_a_ms"][1], "plain_ms": times["plain_a_ms"][1],
         "bound_ms": times["bound_a_ms"][1], "bound_by": "operations",
         "library_ms": None},
        {"name": "fused_ddim_update", "route": "triton",
         "source": "music_style_transfer_ldm_tpu_torch/ops/ddim_update.py",
         "replaces": "music_style_transfer_ldm_tpu/ops/pallas/"
                     "ddim_update.py:52",
         "launches": wav_launches["fused_ddim_update"],
         "max_abs_err": err_b, "ms": kb_ms, "plain_ms": pb_ms,
         "bound_ms": bound_b_ms, "bound_by": "bytes", "library_ms": None},
        {"name": "fused_mel_unit_image", "route": "cuda",
         "source": "music_style_transfer_ldm_tpu_torch/csrc/"
                   "fused_mel_image.cu",
         "replaces": "music_style_transfer_ldm_tpu/ops/pallas/"
                     "fused_mel_image.py:68",
         "launches": wav_launches["fused_mel_unit_image"],
         "max_abs_err": err_c, "ms": times["kernel_c_ms"][1],
         "plain_ms": times["plain_c_ms"][1],
         "bound_ms": times["bound_c_ms"][1], "bound_by": times["bound_c_by"][1],
         "library_ms": None},
    ]
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in
                                 results["launches"].items()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**results, "kernels": kernels}, f, indent=1)
    print("library call: none (no single PyTorch call computes any of the "
          "three functions); kernel times at B=1 in the line below, the "
          "scan route and B=8 beside them above")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
