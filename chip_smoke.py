#!/usr/bin/env python3
"""The PyTorch port's check on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card is required (there is no CPU path);
  2. build: nvcc compiles the fused-trajectory kernel (A), the DDIM
     update (B), the mel front-end kernel (C), the normalized-MSE layer
     (D) and the VGGish trunk (E), all CUDA C++ for sm_90a, one nvcc per
     source, in parallel;
  3. every kernel against its plain PyTorch version at the main paths'
     shapes, with the tolerances stated below (B with f32 and bf16 eps,
     out of place and in place with its pred_x0 output; C on four
     spectrum sets, then on a filterbank with no zero entry and on one
     with all-zero rows); kernel D's six-column
     statistics and its run-to-run determinism; kernel E's five bf16
     convs one by one at B=128 (forward and input gradient, integer and
     random operands, against exact f32 tap sums), timed beside their
     bound and a cuDNN bf16 call;
  4. the image-level path: SDEdit transfer served by the InferenceEngine
     at full width (random weights from seed 0, bf16), on the fused route
     (every bucket of the ladder) and, through a second engine, the scan
     route, with the kernels' launch counts read around it;
  5. the WAV path, as a user runs it: a port checkpoint of the same
     weights, ``cli transfer`` (a 9 s 44.1 kHz stereo WAV -> PNG + WAV,
     fused sampler, 100 steps, overlap 0.5, content phases), ``cli
     generate``, and the HTTP server on an ephemeral localhost port
     answering /v1/transfer (WAV content) and /v1/generate, with the
     launch counts of all three kernels read around it;
  6. the training path: ``cli generate-pairings`` and ``cli train
     --model ldm --epochs 1`` at full width (two steps at B=128, bf16,
     defaults) on seeded PNGs, three steps with the style gradient on and
     VGGish as the compression metric, and ``cli transfer`` from the
     trained checkpoint, with the launch counts of all five kernels read
     around it; then one f32 step at B=8 through the kernels against the
     same step through the plain versions;
  6b. the reference's two-phase recipe: ``cli train --model autoencoder
     --epochs 2`` at the defaults (B=128, f32, LPIPS) on the same PNGs,
     ``cli train --model ldm --pretrained-ae`` from its result (the
     frozen encoder checked bit for bit in ``ldm_final.pt``), ``cli
     transfer`` from that, and ``load_ldm``'s fallback from a corrupt
     full checkpoint to the AE checkpoint; seeded reference-layout
     ``encoder.pth`` / ``decoder.pth`` / ``vggish.pth`` through ``cli
     import-torch`` and one LDM epoch from them (the imported trunk feeds
     kernel E); three AE steps at B=128 f32 with the imported trunk as
     the VGGish compression metric (kernel D's forward and target-side
     backward), and one f32 AE step at B=8 through the kernels against
     the plain versions, under ``debug_mode``; the launch counts read
     around each;
  6c. the distillation and evaluation path: ``cli distill --stages
     96,48,24,12,6 --steps-per-stage 4 --inflight-every 2`` at the
     defaults (B=128, bf16, t_max 100) from phase 6's checkpoint (five
     students, their metadata, the frozen parts bit for bit, the UNet
     moved, finite losses, the closing line's grid) and a guided cascade
     ``--stages 6,3 --guidance 2.0`` that collapses to one step; the
     3-step student served on its grid by ``cli transfer`` (fused: no
     warning, one kernel A launch per group of chunks; ``--sample-steps
     7`` warns; ``--sampler ddim``: three kernel B launches) and by the
     HTTP server, whose engine adopts the grid (one A launch per
     request); the evaluation block on B=8 seeded pairs (the teacher's
     99-step transfer, the teacher and the student on the 4-point grid,
     pixel MSE / PSNR printed; ``independent_transfer_metrics`` on the
     card: kernel E f32 value-only with kernel D inside); ``cli
     diagnose``; the launch counts read around all of it; then kernel A
     against its plain version on the students' 3- and 1-step grids (f32
     and bf16, B = 1 and 8, DDIM and DPM++), the evaluation's VGGish
     distances against the plain version, and ``trunk_embeddings`` on the
     card against the CPU;
  7. times with CUDA events (host clock for the CLI, HTTP and training
     steps), each printed with the card's name and power limit: kernel A
     at B = 1, 2, 4, 8 beside the scan route and the bound, with its grid,
     shared memory per block and launch plan; kernels B and C back to
     back, and also their device time per launch (torch.profiler) and
     host time per call (1,000 calls, no sync); a profile of one
     training step; the AE step at B=128 f32 with LPIPS and with VGGish
     compression (host clock, device time, idle share, peak memory); and
     kernel D in f32 at layer 1, B=128, held against its plain version
     (m, statistics, target gradient) and timed beside its bytes bound;
     kernel A on the students' 6-, 3- and 1-step grids at B = 1 and 8
     beside its 49-step time and the bound of each; the 3-step student's
     ``cli transfer`` beside its teacher's 99-step one on the same clip;
     the evaluation block's wall time; kernel E f32 value-only at the
     evaluation batch beside its bound; and the distill step at B=128
     bf16, factor 2, unguided and guided (host clock, device time, idle
     share, peak memory).
The line before the last is the per-kernel JSON summary; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import dataclasses
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
# Kernel A f32, one element alone vs inside a batch of 8 on the same
# packed operands: each output sums its own element's K in an order that
# does not depend on B, so by design the difference is 0.
TOL_ALONE = 1e-4
# Kernel C vs its plain version: summation order and log10f's last bit
# may move a value by one step of the /255 grid, on few elements.
TOL_KERNEL_C = 1.0 / 255.0 + 1e-6
TOL_KERNEL_C_FLIPS = 1e-3   # share of elements one grid step apart
TOL_GRID = 1e-4             # |255 x - round(255 x)| of every output
# Kernel D (f32) vs plain: m and the loss to 1e-5; dp, dt to the JAX
# suite's rtol 1e-4 / atol 1e-7; dw to atol 1e-6.  bf16 loss to 1e-3.
TOL_D_VALUE, TOL_D_GRAD, ATOL_D_GRAD, ATOL_D_DW = 1e-5, 1e-4, 1e-7, 1e-6
TOL_D_BF16 = 1e-3
# Kernel E (f32) vs plain: the value to 1e-5; the pred gradient's max
# abs error below 1e-4 of its max where both versions pool alike (an
# integer-valued trunk: every conv output is exact in f32, so the maps
# are bit-identical); on a random trunk a near-tie in a 2x2 max-pool can
# route a gradient to another pixel (the two sum in other orders), so
# there the relative L2 error is held to 1e-3.
TOL_E_VALUE, TOL_E_GRAD_OF_MAX, TOL_E_REL_L2 = 1e-5, 1e-4, 1e-3
# bf16: E's gradient as close to the f32 oracle as the plain bf16
# version's (2x) or 5 %, the value within 2 %.
TOL_E_BF16_FLOOR, TOL_E_BF16_VALUE = 0.05, 0.02
# One f32 training step through the kernels vs through the plain
# versions: losses to 1e-5, each parameter gradient to 1e-4 of its max.
# Both run with cuDNN's deterministic algorithms: the atomics of the
# others add run-to-run noise that the decoder's train-mode BatchNorm
# amplifies past that bar.  With the style gradient on, the step takes
# E's pred gradient, whose max-pool near-tie routing differs from the
# plain trunk's (phase 3 counts the elements that move); summed into the
# parameter gradients that is 2e-4 to 4e-4 of a gradient's max in runs
# of this script, so that run is held to 1e-3.
TOL_STEP_LOSS, TOL_STEP_GRAD, TOL_STEP_GRAD_ROUTED = 1e-5, 1e-4, 1e-3

# Kernel D's statistics [B, 6] vs the plain version's: each column to
# 1e-5 of its largest magnitude over the batch (single-pass moments vs
# two-pass and direct sums).
TOL_D_STATS = 1e-5
# Kernel E's bf16 convs (tensor cores) vs conv_relu's rounding points /
# an f32 transposed conv, on the same bf16-rounded operands, summed tap
# by tap in exact f32 (cuBLAS SGEMM, TF32 off; cuDNN's f32 algorithms at
# these shapes are not exact on integers).  Integer-valued operands:
# every f32 sum is exact, so 0 mismatches.  Random forward: at most one bf16
# ulp on every element, an ulp taken no lower than at 2^-11 of the map's
# max (below it the f32 rounding of sums of up to 4,608 products, in other
# orders, exceeds a bf16 ulp of the result), and one-ulp flips on at most
# 1e-3 of the elements.  Random input gradient (f32 out): max abs error
# 1e-5 of the max.
TOL_CONV_FLIPS, TOL_DGRAD_OF_MAX = 1e-3, 1e-5
# Kernel E bf16 on an integer-valued trunk: the maps are bit-identical to
# the plain bf16 trunk's, so the value agrees to the metrics' f32 sums.
TOL_E_INT_BF16 = 1e-5
# The VGGish trunk's convs at 128x128: (name, H = W, Cin, Cout).
TRUNK_CONVS = (("conv2", 64, 64, 128), ("conv3_1", 32, 128, 256),
               ("conv3_2", 32, 256, 256), ("conv4_1", 16, 256, 512),
               ("conv4_2", 16, 512, 512))

# trunk_embeddings (the plain f32 trunk, TF32 off) on the card vs the CPU:
# max abs error / max |embedding| (cuDNN's and the CPU's sums differ in
# order only).
TOL_EMBED = 1e-4

H100_BF16_FLOPS = 989e12   # dense, tensor cores
H100_F32_FLOPS = 67e12     # outside the tensor cores
H100_BYTES = 3.35e12       # HBM3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean ms per call of fn over reps calls, CUDA events, after one
    warm-up call."""
    import torch
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


def host_us(fn, reps=1000):
    """Mean host microseconds per call of fn over reps calls with no
    sync between them (the issue cost), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def device_us(fn, kernel, reps=50):
    """Mean device microseconds per launch of the kernels whose name holds
    ``kernel``, from torch.profiler over reps calls of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key and str(getattr(
                evt, "device_type", "")).endswith("CUDA"):
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
            count += evt.count
    check(count >= reps, f"the profile saw {count} launches of {kernel}")
    return total / count


def conv_taps_f32(x, w9, dgrad):
    """A 3x3 pad-1 conv (or, with dgrad, its input gradient) of NHWC f32
    x with w9 [9, Cin, Cout] (tap = 3 ky + kx): nine f32 matmuls of the
    shifted maps, exact on integer-valued operands."""
    import torch
    n, h, w, _ = x.shape
    pad = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        if dgrad:
            dy, dx = -dy, -dx
        src = pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        y = src @ (w9[tap].T if dgrad else w9[tap])
        acc = y if acc is None else acc + y
    return acc


def trunk_conv_checks(ft, vgg16, ivgg16, B, card, g) -> dict:
    """Kernel E's bf16 convs one by one at the trunk's shapes for batch B
    (forward on both branches, 2B images; input gradient on the pred
    half, B): held against conv_relu's rounding points and an f32
    transposed conv of the same bf16-rounded operands (``conv_taps_f32``),
    on integer-valued and random operands, and timed beside their bound
    and one cuDNN bf16 channels_last call."""
    import torch
    import torch.nn.functional as F
    dev = torch.device("cuda")
    bf = torch.bfloat16
    out = {}
    for name, hw, cin, cout in TRUNK_CONVS:
        r = out[name] = {}
        conv, iconv = getattr(vgg16, name), getattr(ivgg16, name)
        for tag, c in (("int", iconv), ("rand", conv)):
            if tag == "int":
                x = torch.randint(0, 4, (2 * B, hw, hw, cin), device=dev,
                                  generator=g).to(bf)
                gy = torch.randint(-2, 3, (B, hw, hw, cout), device=dev,
                                   generator=g).to(bf)
            else:
                x = torch.relu(torch.randn(2 * B, hw, hw, cin, device=dev,
                                           generator=g)).to(bf)
                gy = (torch.randn(B, hw, hw, cout, device=dev, generator=g)
                      * 1e-3).to(bf)
            y = ft.trunk_conv(x, c)
            dx = ft.trunk_conv_dgrad(gy, c)
            w9 = ft.dgrad_weights(c, bf).float()
            y_ref = torch.relu((conv_taps_f32(x.float(), w9, False)
                                + c.bias.detach().float()).to(bf))
            dx_ref = conv_taps_f32(gy.float(), w9, True)
            torch.cuda.synchronize()
            yk, yr = y.float(), y_ref.float()
            diff = (yk - yr).abs()
            if tag == "int":
                r["int_fwd_mismatches"] = int((diff > 0).sum())
                r["int_dgrad_mismatches"] = int((dx != dx_ref).sum())
                continue
            top = torch.maximum(yk.abs(), yr.abs()).clamp_min(
                2.0 ** -11 * yr.abs().max())
            r["fwd_ulps_max"] = (diff / (top * 2.0 ** -7)).max().item()
            r["fwd_flip_share"] = (diff > 0).float().mean().item()
            r["dgrad_of_max"] = ((dx - dx_ref).abs().max()
                                 / dx_ref.abs().max()).item()
        # times: the kernels, their bound, cuDNN bf16 channels_last
        wf, wd = ft.forward_weights(conv, bf), ft.dgrad_weights(conv, bf)
        r["fwd_ms"] = cuda_ms(lambda: ft.trunk_conv(x, conv, wf), 10)
        r["dgrad_ms"] = cuda_ms(lambda: ft.trunk_conv_dgrad(gy, conv, wd),
                                10)
        xc = x.permute(0, 3, 1, 2)          # NHWC memory: channels_last
        gc = gy.permute(0, 3, 1, 2)
        wc = conv.weight.detach().to(bf).contiguous(
            memory_format=torch.channels_last)
        bc = conv.bias.detach().to(bf)
        r["cudnn_fwd_ms"] = cuda_ms(lambda: F.conv2d(xc, wc, bc, padding=1),
                                    10)
        r["cudnn_dgrad_ms"] = cuda_ms(lambda: torch.nn.grad.conv2d_input(
            (B, cin, hw, hw), wc, gc, padding=1), 10)
        macs = hw * hw * cin * cout * 9
        wbytes = 9 * cin * cout * 2
        for key, n_img, in_c, out_bytes in (
                ("fwd", 2 * B, cin, 2 * B * hw * hw * cout * 2),
                ("dgrad", B, cout, B * hw * hw * cin * 4)):
            flops = 2 * macs * n_img
            nbytes = n_img * hw * hw * in_c * 2 + wbytes + out_bytes
            r[f"{key}_bound_ms"] = 1e3 * max(flops / H100_BF16_FLOPS,
                                             nbytes / H100_BYTES)
            r[f"{key}_tflops"] = flops / (r[f"{key}_ms"] * 1e-3) / 1e12
        print(f"time {card} kernel E conv {name} {hw}x{hw} {cin}->{cout} "
              f"bf16 B={B}: forward (2B) {r['fwd_ms']:.3f} ms "
              f"({r['fwd_tflops']:.0f} TFLOP/s; bound "
              f"{r['fwd_bound_ms']:.4f}, cuDNN {r['cudnn_fwd_ms']:.3f}), "
              f"input grad (B) {r['dgrad_ms']:.3f} ms "
              f"({r['dgrad_tflops']:.0f} TFLOP/s; bound "
              f"{r['dgrad_bound_ms']:.4f}, cuDNN {r['cudnn_dgrad_ms']:.3f});"
              f" integer mismatches fwd {r['int_fwd_mismatches']}, dgrad "
              f"{r['int_dgrad_mismatches']}; random fwd max "
              f"{r['fwd_ulps_max']:.3g} ulp, flips {r['fwd_flip_share']:.3g}"
              f", dgrad max abs / max {r['dgrad_of_max']:.3g}")
        del x, gy, y, dx, y_ref, dx_ref
    return out


def profiled_kernels(fn, log_dir: Path):
    """[(device us, kernel name)] of the card's kernels in one call of fn,
    largest first, from the port's ``utils/profiling.py trace`` of that
    call (which also writes it to ``log_dir/trace.json``)."""
    from music_style_transfer_ldm_tpu_torch.utils.profiling import trace
    with trace(log_dir) as prof:
        fn()
    out = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue      # host-side ops; their kernels are listed apart
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            out.append((dev_us, evt.key))
    return sorted(out, reverse=True)


def grad_err_of_max(got: dict, want: dict) -> float:
    """Max over parameters of max |got - want| / max |want|, skipping
    gradients below 1e-5 of the largest (a conv bias feeding a train-mode
    BatchNorm, whose true gradient is 0)."""
    top = max(v.abs().max().item() for v in want.values())
    err = 0.0
    for k, v in want.items():
        scale = v.abs().max().item()
        if scale < 1e-5 * top:
            continue
        err = max(err, (got[k] - v).abs().max().item() / scale)
    return err


def run_cli(cli, argv) -> tuple:
    """cli.main(argv) with its stdout and stderr captured, then echoed:
    -> (stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    sys.stdout.write(out.getvalue())
    sys.stderr.write(err.getvalue())
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return out.getvalue(), err.getvalue()


def write_reference_weights(out: Path, seed: int) -> dict:
    """Seeded random weights in the reference's own key layouts (no real
    weights are in the repository): its encoder and decoder Sequentials
    as ``encoder.pth`` / ``decoder.pth``, and torchvggish's ``features``
    as ``vggish.pth``.  Returns their paths."""
    import numpy as np
    import torch
    from torch import nn
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    enc = nn.Sequential(
        nn.Conv2d(1, 64, 3, 2, 1), nn.BatchNorm2d(64), nn.ReLU(),
        nn.Conv2d(64, 128, 3, 2, 1), nn.BatchNorm2d(128), nn.ReLU(),
        nn.Conv2d(128, 32, 3, 2, 1), nn.BatchNorm2d(32))
    dec = nn.Sequential(
        nn.ConvTranspose2d(32, 128, 4, 2, 1), nn.BatchNorm2d(128), nn.ReLU(),
        nn.ConvTranspose2d(128, 64, 4, 2, 1), nn.BatchNorm2d(64), nn.ReLU(),
        nn.ConvTranspose2d(64, 1, 4, 2, 1), nn.Tanh())
    with torch.no_grad():
        for m in list(enc) + list(dec):
            if isinstance(m, nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.tensor(0.1 * rng.randn(n)))
                m.running_var.copy_(torch.tensor(0.5 + rng.rand(n)))
    vggish = {}
    for cin, cout, idx in ((1, 64, 0), (64, 128, 3), (128, 256, 6),
                           (256, 256, 8), (256, 512, 11), (512, 512, 13)):
        vggish[f"features.{idx}.weight"] = torch.tensor(
            rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin), dtype=torch.float32)
        vggish[f"features.{idx}.bias"] = torch.tensor(
            0.01 * rng.randn(cout), dtype=torch.float32)
    paths = {"encoder": out / "encoder.pth", "decoder": out / "decoder.pth",
             "vggish": out / "vggish.pth"}
    out.mkdir(parents=True, exist_ok=True)
    torch.save({f"encoder.{k}": v for k, v in enc.state_dict().items()},
               paths["encoder"])
    torch.save({f"decoder.{k}": v for k, v in dec.state_dict().items()},
               paths["decoder"])
    torch.save(vggish, paths["vggish"])
    return paths


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
    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.datasets.folder import (
        load_image_unit,
    )
    from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
        ddim_sample, transfer_time_grid,
    )
    from music_style_transfer_ldm_tpu_torch.evaluation import (
        independent_transfer_metrics, style_distances_multiseed,
        trunk_embeddings,
    )
    from music_style_transfer_ldm_tpu_torch.losses.feature import (
        build_feature_metric,
    )
    from music_style_transfer_ldm_tpu_torch.losses.vggish import (
        VGGishFeatures,
    )
    from music_style_transfer_ldm_tpu_torch.models.autoencoder import (
        SpectrogramEncoder,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import (
        build_ldm, load_ldm,
    )
    from music_style_transfer_ldm_tpu_torch.ops import fused_mel_image as fm
    from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
    from music_style_transfer_ldm_tpu_torch.ops import fused_trunk as ft
    from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm
    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        build_ddim_update, ddim_step_reference, ddim_update_,
        ddim_update_reference, fused_ddim_update, step_scalars,
    )
    from music_style_transfer_ldm_tpu_torch.serving.engine import (
        EngineConfig, InferenceEngine,
    )
    from music_style_transfer_ldm_tpu_torch.serving.server import serve
    from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
        load_autoencoder, load_feature_checkpoint, save_checkpoint,
    )
    from music_style_transfer_ldm_tpu_torch.training.distill import (
        ProgressiveDistiller,
    )
    from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (
        AETrainer,
    )
    from music_style_transfer_ldm_tpu_torch.training.train_ldm import (
        LDMTrainer,
    )
    from music_style_transfer_ldm_tpu_torch.utils.png import (
        read_png_gray, write_png_gray,
    )
    from music_style_transfer_ldm_tpu_torch.utils.profiling import (
        StepTimer, debug_mode,
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

    # ---- 2. build (one nvcc per source, all at once) --------------------
    built: dict = {"A": {}, "B": {}, "C": {}, "D": {}, "E": {}}

    def nvcc_build(key, fn):
        try:
            built[key].update(fn())
        except Exception as e:  # noqa: BLE001 — reported below
            built[key]["error"] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=nvcc_build, args=a) for a in (
        ("A", fs.build_fused_sampler), ("B", build_ddim_update),
        ("C", fm.build_fused_mel_image), ("D", nm.build_normalized_mse),
        ("E", ft.build_fused_trunk))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    build_s = time.perf_counter() - t0
    for key in built:
        if "error" in built[key]:
            fail(f"kernel {key} build: {built[key]['error']}")
        for line in built[key]["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas ({key}):", line.strip())
    print("build: nvcc " + ", ".join(
        f"{built[k]['seconds']:.1f} s (kernel {k})" for k in built)
        + f" in parallel, {build_s:.1f} s in all")
    results["build_s"] = {**{f"nvcc_{k.lower()}": built[k]["seconds"]
                             for k in built}, "all": build_s}

    # ---- 3. kernels against their plain versions -----------------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ldm32 = build_ldm(dtype=torch.float32, device=dev, seed=0)
    ab = ldm32.schedule.alpha_bars_np
    x = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    e = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    err_b = {}
    for eps_type, ee in (("f32", e), ("bf16", e.bfloat16())):
        for t, eta in ((49, 0.0), (49, 0.5), (1, 0.0)):
            a_t, a_n = float(ab[t]), float(ab[t - 1])
            k = fused_ddim_update(x, ee, a_t, a_n, eta)
            r = ddim_update_reference(x, ee, a_t, a_n, eta)
            sc = step_scalars(a_t, a_n, eta)
            xi, x0 = x.clone(), torch.empty_like(x)
            ddim_update_(xi, ee, sc, x0)
            _, r0 = ddim_step_reference(x, ee, sc)
            torch.cuda.synchronize()
            for route, got, want in (("out of place", k, r),
                                     ("in place", xi, r),
                                     ("pred_x0", x0, r0)):
                key = f"{eps_type} {route}"
                err_b[key] = max(err_b.get(key, 0.0),
                                 (got - want).abs().max().item())
    print(f"kernel B vs plain [8,16,16,32] (eps f32 and bf16; t = 49, 1; "
          f"eta 0, 0.5): max abs err {err_b} (expected 0; tol "
          f"{TOL_KERNEL_B})")
    check(max(err_b.values()) <= TOL_KERNEL_B,
          "kernel B disagrees with its plain version")
    err_b = max(err_b.values())

    content = torch.rand(8, 128, 128, 1, device=dev, generator=g)
    style = torch.rand(8, 128, 128, 1, device=dev, generator=g)

    def packed(ldm, B, sampler="ddim", eta=0.0, steps=None, t_max=50):
        times = transfer_time_grid(t_max, steps)
        z_t = ldm.noised_latents(content[:B], t_max, seeds=np.arange(B))
        ops = fs.pack_operands(ldm.unet, ldm.style_embed(style[:B]),
                               ldm.schedule, times, eta, sampler=sampler,
                               batch=B)
        return ops, z_t.permute(0, 2, 3, 1).contiguous(), len(times) - 1

    err_a = 0.0
    for B in (1, 3, 8):
        for sampler, eta, steps in (("ddim", 0.0, None), ("ddim", 0.5, None),
                                    ("dpm++", 0.0, 25)):
            ops, z_t, n = packed(ldm32, B, sampler, eta, steps)
            k = fs.fused_ddim_sample(ops, z_t, n)
            r = fs.reference_ddim_sample(ops, z_t, n)
            torch.cuda.synchronize()
            err = (k - r).abs().max().item()
            check(bool(torch.isfinite(k).all()), "kernel A gave non-finite")
            print(f"kernel A vs plain f32 B={B} {sampler} eta={eta} "
                  f"steps={n}: max abs err {err:.3g} on latents (tol "
                  f"{TOL_KERNEL_A})")
            err_a = max(err_a, err)
    check(err_a <= TOL_KERNEL_A, "kernel A (f32) disagrees with its plain "
          "version")
    # one element alone vs inside the batch, on the same packed operands
    ops8, z8, n8 = packed(ldm32, 8)
    k8 = fs.fused_ddim_sample(ops8, z8, n8)
    err_alone = 0.0
    for i in range(8):
        one = dataclasses.replace(ops8, kv=[t[i:i + 1] for t in ops8.kv],
                                  batch=1)
        k1 = fs.fused_ddim_sample(one, z8[i:i + 1], n8)
        err_alone = max(err_alone, (k1[0] - k8[i]).abs().max().item())
    print(f"kernel A f32 alone vs inside a batch of 8: max abs difference "
          f"{err_alone} (by design 0; tol {TOL_ALONE})")
    check(err_alone <= TOL_ALONE, "kernel A: an element's result depends on "
          "its batch")

    ldm = build_ldm(dtype=torch.bfloat16, device=dev, seed=0)
    err_a16 = 0.0
    for B in (1, 8):
        ops16, z_t16, n16 = packed(ldm, B)
        k = fs.fused_ddim_sample(ops16, z_t16, n16)
        r = fs.reference_ddim_sample(ops16, z_t16, n16)
        dk = ldm.decode_unit(k.permute(0, 3, 1, 2))
        dr = ldm.decode_unit(r.permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        err = (dk - dr).abs().max().item()
        print(f"kernel A vs plain bf16 B={B} ddim steps={n16}: max abs err "
              f"{err:.3g} on decoded images, "
              f"{(k - r).abs().max().item():.3g} on latents (tol "
              f"{TOL_KERNEL_A_BF16} decoded)")
        err_a16 = max(err_a16, err)
    check(err_a16 <= TOL_KERNEL_A_BF16, "kernel A (bf16) disagrees with its "
          "plain version")
    plans = {dt: fs.device_plan(torch.cuda.current_device(), dt)
             for dt in (torch.bfloat16, torch.float32)}
    for dt, plan in plans.items():
        units = [len(x) for x in plan["slots"]]
        wb = plan["weight_bytes"]
        print(f"kernel A plan {dt}: grid {plan['n_blocks']} blocks (one per "
              f"SM) x 512 threads, cooperative; {sum(units)} weight units "
              f"(layer, 16-channel tile, replica), {min(units)}-{max(units)} "
              f"per block; dynamic shared memory {plan['smem_bytes']} B per "
              f"block of {plan['smem_limit']} (weights {min(wb)}-{max(wb)} B "
              f"per block, {sum(wb)} B in all); elements per pass "
              f"{dict(zip(fs._NAMES, plan['groups']))}")

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
    # filterbanks the band table must also get right: no zero entry (full
    # bands), and all-zero rows (empty bands), from a generator of their
    # own so the later phases' data stay those of earlier runs
    g_fb = torch.Generator(device=dev)
    g_fb.manual_seed(6)
    dense_fb = fb + 1e-4 * torch.rand(fb.shape, device=dev, generator=g_fb)
    zero_rows = fb.clone()
    zero_rows[[0, 5, 90]] = 0.0
    for fb_kind, fb_x in (("no zero entry", dense_fb),
                          ("rows 0, 5, 90 all zero", zero_rows)):
        for (kind_c, B), S in spectra.items():
            k = fm.fused_mel_unit_image(fb_x, S)
            r = fm.fused_mel_unit_image_reference(fb_x, S)
            torch.cuda.synchronize()
            d = (k - r).abs()
            err = d.max().item()
            flips = (d > 0.5 / 255.0).float().mean().item()
            print(f"kernel C vs plain, filterbank with {fb_kind}, [{B},1025,"
                  f"130] {kind_c}: max abs err {err:.3g} (tol "
                  f"{TOL_KERNEL_C:.6g}), one-step flips {flips:.3g} (tol "
                  f"{TOL_KERNEL_C_FLIPS})")
            check(err <= TOL_KERNEL_C and flips <= TOL_KERNEL_C_FLIPS,
                  f"kernel C disagrees on a filterbank with {fb_kind}")
    del dense_fb, zero_rows
    grid_c = fm.mel_image_grid(fb, 130)
    print(f"kernel C grid at T=130: {grid_c['groups']} row groups x "
          f"{grid_c['tiles']} frame tile(s) = {grid_c['ctas_per_item']} CTAs "
          f"per item; {grid_c['band_macs']} band-limited multiply-adds per "
          f"item (dense: {128 * 1025 * 130})")
    check(grid_c["ctas_per_item"] > 1, "kernel C runs one CTA per item")

    # kernel D: the six VGGish layer shapes, f32, B=8, one zero weight
    def excess(got, want, rtol, atol):
        """max(|got - want| - atol - rtol |want|): <= 0 passes."""
        return ((got - want).abs() - atol - rtol * want.abs()).max().item()

    w8 = torch.ones(8, device=dev)
    w8[-1] = 0.0
    err_d = {"m": 0.0, "loss": 0.0, "abs": 0.0, "grad_excess": -1.0,
             "dw_excess": -1.0, "stats_of_max": [0.0] * nm.N_STATS}
    for h, w_, c in ((128, 128, 64), (64, 64, 128), (32, 32, 256),
                     (32, 32, 256), (16, 16, 512), (16, 16, 512)):
        p = torch.relu(torch.randn(8, h, w_, c, device=dev, generator=g))
        t = torch.relu(torch.randn(8, h, w_, c, device=dev, generator=g))
        mk, sk = nm.normalized_mse_forward(p, t)
        mr, sr = nm.normalized_mse_forward_reference(p, t)
        col_err = ((sk - sr).abs().max(0).values
                   / sr.abs().max(0).values).tolist()
        err_d["stats_of_max"] = [max(a, b) for a, b in
                                 zip(err_d["stats_of_max"], col_err)]
        out = {}
        for name, fn in (("k", nm.normalized_mse_kernel),
                         ("r", nm.normalized_mse_reference)):
            P, T, W = (x.clone().requires_grad_(True) for x in (p, t, w8))
            loss = fn(P, T, W)
            loss.backward()
            out[name] = (loss.detach(), P.grad, T.grad, W.grad)
        torch.cuda.synchronize()
        (lk, dpk, dtk, dwk), (lr, dpr, dtr, dwr) = out["k"], out["r"]
        err_d["m"] = max(err_d["m"], ((mk - mr).abs() / mr.abs()).max().item())
        err_d["loss"] = max(err_d["loss"], ((lk - lr).abs() / lr).item())
        err_d["grad_excess"] = max(err_d["grad_excess"], excess(
            dpk, dpr, TOL_D_GRAD, ATOL_D_GRAD), excess(
            dtk, dtr, TOL_D_GRAD, ATOL_D_GRAD))
        err_d["dw_excess"] = max(err_d["dw_excess"],
                                 excess(dwk, dwr, 0.0, ATOL_D_DW))
        err_d["abs"] = max(err_d["abs"], (mk - mr).abs().max().item())
    print(f"kernel D vs plain f32 B=8 at the six VGGish layer shapes: m rel "
          f"{err_d['m']:.3g}, loss rel {err_d['loss']:.3g} (tol "
          f"{TOL_D_VALUE}); dp/dt excess over rtol {TOL_D_GRAD} atol "
          f"{ATOL_D_GRAD}: {err_d['grad_excess']:.3g} (<= 0), dw excess "
          f"over atol {ATOL_D_DW}: {err_d['dw_excess']:.3g} (<= 0)")
    check(err_d["m"] <= TOL_D_VALUE and err_d["loss"] <= TOL_D_VALUE,
          "kernel D's metric disagrees with its plain version")
    check(err_d["grad_excess"] <= 0.0 and err_d["dw_excess"] <= 0.0,
          "kernel D's gradients disagree with their plain version")
    print(f"kernel D statistics [B, 6] (mu_p, s_p, mu_t, s_t, a0, b0) vs "
          f"plain f32 at the six shapes: max abs error / column max "
          f"{[float(f'{e:.3g}') for e in err_d['stats_of_max']]} (tol "
          f"{TOL_D_STATS})")
    check(max(err_d["stats_of_max"]) <= TOL_D_STATS,
          "kernel D's statistics disagree with their plain version")
    p16 = torch.relu(torch.randn(128, 128, 128, 64, device=dev,
                                 generator=g)).bfloat16()
    t16 = torch.relu(torch.randn(128, 128, 128, 64, device=dev,
                                 generator=g)).bfloat16()
    w128 = torch.ones(128, device=dev)
    lk = nm.normalized_mse_kernel(p16, t16, w128).item()
    lr = nm.normalized_mse_reference(p16, t16, w128).item()
    err_d["bf16_loss"] = abs(lk - lr) / lr
    print(f"kernel D vs plain bf16 B=128 layer 1: loss rel "
          f"{err_d['bf16_loss']:.3g} (tol {TOL_D_BF16})")
    check(err_d["bf16_loss"] <= TOL_D_BF16, "kernel D (bf16) disagrees")
    runs = [nm.normalized_mse_forward(x16, x16.flip(0)) for x16 in
            (p16, p16, t16, t16)]
    same = all(torch.equal(a, b) for a, b in zip(runs[0] + runs[2],
                                                 runs[1] + runs[3]))
    err_d["deterministic"] = same
    print(f"kernel D forward, bf16 B=128 layer 1, two calls on the same "
          f"inputs (twice): bit-identical m and statistics: {same}")
    check(same, "kernel D's forward is not bit-identical run to run")
    del runs

    # kernel E: full VGGish widths, 128x128
    def e_run(mod, fn, pred, targ, w):
        P = pred.clone().requires_grad_(True)
        T = targ.clone().requires_grad_(True)
        loss = fn(mod, P, T, w)
        loss.backward()
        return loss.item(), P.grad, T.grad

    torch.manual_seed(3)
    vgg32 = VGGishFeatures(torch.float32).to(dev)
    pred8 = torch.rand(8, 128, 128, 1, device=dev, generator=g)
    targ8 = torch.rand(8, 128, 128, 1, device=dev, generator=g)
    vk, gk, tk = e_run(vgg32, ft.fused_vggish_distance, pred8, targ8, w8)
    vr, gr, _ = e_run(vgg32, ft.fused_vggish_distance_reference, pred8,
                      targ8, w8)
    vv = ft.fused_vggish_distance_value(vgg32, pred8, targ8, w8).item()
    err_e = {"value": abs(vk - vr) / vr, "value_abs": abs(vk - vr),
             "rel_l2": ((gk - gr).norm() / gr.norm()).item(),
             "of_max": ((gk - gr).abs().max() / gr.abs().max()).item(),
             "moved": int(((gk - gr).abs() > 1e-4 * gr.abs().max()).sum())}
    ivgg = VGGishFeatures(torch.float32).to(dev)
    with torch.no_grad():
        for conv, _ in ivgg.layers():
            r = torch.rand(conv.weight.shape, device=dev, generator=g)
            conv.weight.copy_(torch.where(r < 0.04, 1.0, torch.where(
                r > 0.96, -1.0, 0.0)))
            conv.bias.copy_(torch.randint(-1, 3, conv.bias.shape, device=dev,
                                          generator=g).float())
    ipred = torch.randint(0, 4, (8, 128, 128, 1), device=dev,
                          generator=g).float()
    itarg = torch.randint(0, 4, (8, 128, 128, 1), device=dev,
                          generator=g).float()
    ivk, igk, _ = e_run(ivgg, ft.fused_vggish_distance, ipred, itarg, w8)
    ivr, igr, _ = e_run(ivgg, ft.fused_vggish_distance_reference, ipred,
                        itarg, w8)
    err_e["int_value"] = abs(ivk - ivr) / ivr
    err_e["int_of_max"] = ((igk - igr).abs().max() / igr.abs().max()).item()
    print(f"kernel E vs plain f32 B=8 128x128 full widths: value rel "
          f"{err_e['value']:.3g} (value-only variant {vv:.8g} vs "
          f"{vk:.8g}); random trunk pred-grad rel L2 {err_e['rel_l2']:.3g} "
          f"(tol {TOL_E_REL_L2}), max abs / max {err_e['of_max']:.3g} with "
          f"{err_e['moved']} of {gk.numel()} elements beyond 1e-4 of max "
          f"(pool near-tie routing); integer trunk (exact maps) value rel "
          f"{err_e['int_value']:.3g}, pred-grad max abs / max "
          f"{err_e['int_of_max']:.3g} (tol {TOL_E_GRAD_OF_MAX}); zero-weight "
          f"sample grad {gk[-1].abs().max().item()}, target grad "
          f"{tk.abs().max().item()}")
    check(err_e["value"] <= TOL_E_VALUE and err_e["int_value"] <= TOL_E_VALUE
          and abs(vv - vk) <= TOL_E_VALUE * vk, "kernel E's value disagrees")
    check(err_e["int_of_max"] <= TOL_E_GRAD_OF_MAX
          and err_e["rel_l2"] <= TOL_E_REL_L2,
          "kernel E's pred gradient disagrees with its plain version")
    check(bool((gk[-1] == 0).all()) and bool((tk == 0).all()),
          "kernel E: the zero-weight sample and the target must get exactly "
          "zero gradients")
    vgg16 = VGGishFeatures(torch.bfloat16).to(dev)
    vgg16.load_state_dict(vgg32.state_dict())
    for B in (8, 128):
        pb = torch.rand(B, 128, 128, 1, device=dev, generator=g)
        tb = torch.rand(B, 128, 128, 1, device=dev, generator=g)
        wb = torch.ones(B, device=dev)
        wb[-1] = 0.0
        v32, g32, _ = e_run(vgg32, ft.fused_vggish_distance_reference, pb,
                            tb, wb)
        vpl, gpl, _ = e_run(vgg16, ft.fused_vggish_distance_reference, pb,
                            tb, wb)
        vke, gke, _ = e_run(vgg16, ft.fused_vggish_distance, pb, tb, wb)
        n32 = g32.norm()
        plain_err = ((gpl - g32).norm() / n32).item()
        kern_err = ((gke - g32).norm() / n32).item()
        bar = max(2.0 * plain_err, TOL_E_BF16_FLOOR)
        err_e[f"bf16_b{B}"] = kern_err
        print(f"kernel E bf16 B={B} vs the f32 oracle: pred-grad rel L2 "
              f"{kern_err:.4g} (plain bf16 {plain_err:.4g}; tol {bar:.4g}), "
              f"value rel {abs(vke - v32) / v32:.3g} (tol "
              f"{TOL_E_BF16_VALUE})")
        check(kern_err <= bar and abs(vke - v32) <= TOL_E_BF16_VALUE * v32,
              f"kernel E (bf16, B={B}) strays from the f32 oracle")
        del g32, gpl, gke
    ivgg16 = VGGishFeatures(torch.bfloat16).to(dev)
    ivgg16.load_state_dict(ivgg.state_dict())
    ivv = ft.fused_vggish_distance_value(ivgg16, ipred, itarg, w8).item()
    ivp = ft.fused_vggish_distance_reference(ivgg16, ipred, itarg,
                                             w8).item()
    err_e["int_bf16_value"] = abs(ivv - ivp) / ivp
    print(f"kernel E bf16 B=8 integer trunk (bit-identical maps) vs the "
          f"plain bf16 version: value rel {err_e['int_bf16_value']:.3g} "
          f"(tol {TOL_E_INT_BF16})")
    check(err_e["int_bf16_value"] <= TOL_E_INT_BF16,
          "kernel E (bf16) disagrees with its plain version on exact maps")
    convs = trunk_conv_checks(ft, vgg16, ivgg16, 128, card, g)
    err_e["convs"] = {k: {m: v[m] for m in (
        "int_fwd_mismatches", "int_dgrad_mismatches", "fwd_ulps_max",
        "fwd_flip_share", "dgrad_of_max")} for k, v in convs.items()}
    for name, r in convs.items():
        check(r["int_fwd_mismatches"] == 0 and r["int_dgrad_mismatches"] == 0,
              f"kernel E {name}: integer operands must give exact results")
        check(r["fwd_ulps_max"] <= 1.0 and r["fwd_flip_share"]
              <= TOL_CONV_FLIPS, f"kernel E {name} forward strays from "
              "conv_relu by more than one bf16 ulp")
        check(r["dgrad_of_max"] <= TOL_DGRAD_OF_MAX,
              f"kernel E {name} input gradient disagrees")
    results["max_abs_err"] = {"ddim_update": err_b, "fused_ddim_sample_f32":
                              err_a, "fused_ddim_sample_bf16_decoded":
                              err_a16, "fused_mel_unit_image": err_c,
                              "fused_mel_unit_image_flip_share": flips_c}
    results["max_abs_err"].update({"normalized_mse": err_d,
                                   "fused_vggish_distance": err_e,
                                   "fused_ddim_sample_alone_vs_batched":
                                   err_alone})
    results["kernel_a_plan"] = {
        str(dt): {k: plan[k] for k in ("n_blocks", "smem_bytes",
                                        "smem_limit", "weight_bytes",
                                        "groups")}
        for dt, plan in plans.items()}

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counted}

    serving = (fs.fused_ddim_sample, fused_ddim_update,
               fm.fused_mel_unit_image)
    counted = serving + (nm.normalized_mse_forward,
                         nm.normalized_mse_backward, ft.fused_trunk)

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
    scan_engine = InferenceEngine(ldm, EngineConfig(sampler="ddim"))
    outs.append(scan_engine.transfer_batch(reqs_c, reqs_s,
                                           seeds=np.arange(8)))
    launches = read_counts()
    print(f"image path: warmup {warm_s:.2f} s; served B=1, B=3 (bucket 4), "
          f"B=8 and 6 submitted requests on the fused route (buckets <= "
          f"{engine.fused_bucket_max}), B=8 on the scan route; launches "
          f"{launches}; stats {engine.stats()}")
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
    for fn in serving:
        check(wav_launches[fn.__name__] > 0,
              f"{fn.__name__} never ran on the WAV path")
    results["launches"]["wav_path"] = wav_launches

    # ---- 6. the training path ------------------------------------------
    tdir = work / "train"
    imgs = tdir / "images"
    img_rng = np.random.RandomState(1)
    for label in ("classic", "rock"):
        (imgs / label).mkdir(parents=True, exist_ok=True)
        for i in range(16):
            (imgs / label / f"{i:03d}.png").write_bytes(write_png_gray(
                img_rng.randint(0, 256, (128, 128)).astype(np.uint8)))
    pairs_csv = tdir / "pairs.csv"
    cli.main(["generate-pairings", "--root", str(imgs), "--output",
              str(pairs_csv), "--num-pairs", "256"])
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "--model", "ldm", "--data-root", str(imgs),
              "--pairing-file", str(pairs_csv), "--epochs", "1",
              "--out-dir", str(tdir / "run")])
    torch.cuda.synchronize()
    cli_train_s = time.perf_counter() - t0
    trained = tdir / "run" / "ldm_final.pt"
    payload = torch.load(trained, map_location="cpu", weights_only=True)
    rows = (tdir / "run" / "metrics.csv").read_text().splitlines()
    header, last = rows[0].split(","), rows[-1].split(",")
    logged = {k: float(v) for k, v in zip(header, last)}
    print(f"cli train --model ldm --epochs 1 (256 pairs, B=128, bf16): "
          f"{cli_train_s:.2f} s wall, step {payload['step']}, epoch metrics "
          f"{ {k: round(v, 5) for k, v in logged.items()} }")
    check(payload["step"] == 2, f"cli train ran {payload['step']} steps")
    check(all(np.isfinite(logged[k]) for k in (
        "total_loss", "compression_loss", "denoising_loss", "style_loss")),
        "cli train logged a non-finite loss")
    cfg_v = default_config()
    cfg_v.train = dataclasses.replace(
        cfg_v.train, style_loss_stop_gradient=False,
        compression_feature_extractor="vggish")
    trainer_v = LDMTrainer(cfg_v)
    state_v = trainer_v.init_state(0)
    c128 = torch.rand(128, 128, 128, 1, device=dev, generator=g)
    s128 = torch.rand(128, 128, 128, 1, device=dev, generator=g)
    variant_metrics = []
    for _ in range(3):
        state_v, m_v = trainer_v._step(state_v, c128, s128)
        variant_metrics.append({k: v.item() for k, v in m_v.items()})
    print(f"LDMTrainer, style gradient on, VGGish compression metric, B=128 "
          f"bf16, 3 steps: {variant_metrics}")
    check(all(np.isfinite(v) for m in variant_metrics for v in m.values()),
          "the style-gradient variant gave a non-finite loss")
    cli.main(["transfer", "--checkpoint", str(trained), "--content",
              str(content_wav), "--style", str(imgs / "rock" / "000.png"),
              "--sampler", "fused", "--steps", "50", "--overlap", "0.5",
              "--output", str(work / "trained_transfer")])
    png = read_png_gray((work / "trained_transfer.png").read_bytes())
    sr_out, audio = wavfile.read(work / "trained_transfer.wav")
    check(png.shape == (128, 128 * n_chunks) and sr_out == 22050
          and bool(np.isfinite(audio).all()), "transfer from the trained "
          "checkpoint")
    train_launches = read_counts()
    print(f"training path: launches {train_launches}; cli transfer from "
          f"{trained.name}: PNG {png.shape}, WAV {audio.shape[0]} samples")
    for fn in counted:
        if fn is not fused_ddim_update:   # the transfer runs kernel A
            check(train_launches[fn.__name__] > 0,
                  f"{fn.__name__} never ran on the training path")
    results["launches"]["training_path"] = train_launches

    # one f32 step at B=8: through the kernels vs through the plain versions
    lat = torch.Generator(device=dev)
    lat.manual_seed(8)
    c8 = torch.rand(8, 128, 128, 1, device=dev, generator=lat)
    s8 = torch.rand(8, 128, 128, 1, device=dev, generator=lat)
    t8 = torch.randint(0, 200, (8,), device=dev, generator=lat)
    n8 = torch.randn(8, 16, 16, 32, device=dev, generator=lat)
    err_step = {}
    torch.backends.cudnn.deterministic = True
    for tag, over, tol in (
            ("defaults", {}, TOL_STEP_GRAD),
            ("vggish-compression", {
                "compression_feature_extractor": "vggish"}, TOL_STEP_GRAD),
            ("style-grad+vggish-compression", {
                "style_loss_stop_gradient": False,
                "compression_feature_extractor": "vggish"},
             TOL_STEP_GRAD_ROUTED)):
        cfg32 = default_config()
        cfg32.train = dataclasses.replace(cfg32.train,
                                          compute_dtype="float32", **over)
        runs = {}
        for impl in ("auto", "plain"):
            tr = LDMTrainer(cfg32, feature_impl=impl)
            st = tr.init_state(0)
            total, mets = tr._losses(st.model, c8, s8, t8, noise=n8)
            total.backward()
            runs[impl] = (mets, {k: p.grad for k, p in
                                 st.model.named_parameters()
                                 if p.grad is not None})
        (mk, gk8), (mr, gr8) = runs["auto"], runs["plain"]
        loss_err = max(abs(mk[k].item() - mr[k].item()) / abs(mr[k].item())
                       for k in mr)
        grad_err = grad_err_of_max(gk8, gr8)
        err_step[tag] = {"loss": loss_err, "grad_of_max": grad_err}
        print(f"f32 step B=8 ({tag}): kernels vs plain versions, losses rel "
              f"{loss_err:.3g} (tol {TOL_STEP_LOSS}), parameter gradients "
              f"max abs / max {grad_err:.3g} (tol {tol})")
        check(loss_err <= TOL_STEP_LOSS and grad_err <= tol,
              f"the f32 training step ({tag}) through the kernels disagrees "
              "with the plain versions")
    torch.backends.cudnn.deterministic = False
    results["max_abs_err"]["f32_step"] = err_step

    # ---- 6b. the reference's two-phase recipe ----------------------------
    # phase 1 as a user runs it (defaults: B=128, f32, LPIPS), the handoff
    # to phase 2, a transfer from its result, load_ldm's fallback, kernel D
    # on the phase-1 path (VGGish compression), and the reference's own
    # weights imported and trained from
    rdir = tdir / "recipe"
    reset_counts()
    t0 = time.perf_counter()
    cli.main(["train", "--model", "autoencoder", "--data-root", str(imgs),
              "--epochs", "2", "--out-dir", str(rdir / "ae")])
    torch.cuda.synchronize()
    cli_ae_s = time.perf_counter() - t0
    rows = (rdir / "ae" / "metrics.csv").read_text().splitlines()
    ae_rows = [dict(zip(rows[0].split(","), map(float, r.split(","))))
               for r in rows[1:]]
    ae_state = torch.load(rdir / "ae" / "train_state_final.pt",
                          map_location="cpu", weights_only=True)
    print(f"cli train --model autoencoder --epochs 2 (32 images split 25 / "
          f"7, B=128, f32, LPIPS): {cli_ae_s:.2f} s wall, step "
          f"{ae_state['step']}, epochs "
          f"{[{k: round(v, 6) for k, v in r.items()} for r in ae_rows]}")
    check(len(ae_rows) == 2 and all(np.isfinite(r[k]) for r in ae_rows
                                    for k in ("train_loss", "val_loss")),
          "cli train --model autoencoder: metrics.csv needs two finite "
          "train_loss / val_loss rows")
    check(ae_state["step"] == 2, f"the AE ran {ae_state['step']} steps")
    for name in ("pretrained.pt", "pretrained_final.pt"):
        check((rdir / "ae" / name).exists(), f"no {name}")
    ae_ckpt = rdir / "ae" / "pretrained_final.pt"
    cli.main(["train", "--model", "ldm", "--data-root", str(imgs),
              "--pairing-file", str(pairs_csv), "--epochs", "1",
              "--pretrained-ae", str(ae_ckpt), "--out-dir",
              str(rdir / "ldm")])
    handoff = torch.load(rdir / "ldm" / "ldm_final.pt", map_location="cpu",
                         weights_only=True)
    ae_params = load_autoencoder(ae_ckpt)["params"]
    moved = [k for k, v in ae_params["encoder"].items()
             if not torch.equal(handoff["params"][f"encoder.{k}"], v)]
    print(f"handoff: ldm_final.pt (step {handoff['step']}) holds phase 1's "
          f"encoder bit for bit: {not moved} ({len(ae_params['encoder'])} "
          f"tensors, parameters and BatchNorm statistics)")
    check(handoff["step"] == 2 and not moved, f"the frozen encoder moved in "
          f"phase 2: {moved[:3]}")
    cli.main(["transfer", "--checkpoint", str(rdir / "ldm" / "ldm_final.pt"),
              "--content", str(content_wav), "--style",
              str(imgs / "rock" / "000.png"), "--sampler", "fused",
              "--steps", "50", "--overlap", "0.5", "--output",
              str(rdir / "transfer")])
    png = read_png_gray((rdir / "transfer.png").read_bytes())
    sr_out, audio = wavfile.read(rdir / "transfer.wav")
    want_len = (n_chunks - 1) * hop + 66150
    print(f"cli transfer from the phase-2 checkpoint: PNG {png.shape}, WAV "
          f"{audio.shape[0]} samples at {sr_out} Hz (want {want_len})")
    check(png.shape == (128, 128 * n_chunks) and sr_out == 22050
          and audio.shape == (want_len,) and bool(np.isfinite(audio).all()),
          "transfer from the phase-2 checkpoint")
    corrupt = rdir / "corrupt.pt"
    corrupt.write_bytes(b"\x00 not a checkpoint")
    torch.backends.cudnn.deterministic = True
    fallback = load_ldm(full_checkpoint=str(corrupt),
                        autoencoder_checkpoint=str(ae_ckpt),
                        dtype=torch.float32)
    ae_encoder = SpectrogramEncoder().to(dev).eval()
    ae_encoder.load_state_dict(ae_params["encoder"])
    with torch.no_grad():
        z_fb = fallback.encode(c8)
        z_ae = ae_encoder(c8.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.backends.cudnn.deterministic = False
    fb_err = (z_fb - z_ae).abs().max().item()
    print(f"load_ldm(corrupt full checkpoint, autoencoder_checkpoint=AE): "
          f"fell back; encode of 8 images vs the AE's encoder: max abs "
          f"difference {fb_err} (want 0: the same weights and kernels)")
    check(fb_err == 0.0, "load_ldm's fallback does not encode as the AE")
    recipe_launches = read_counts()
    print(f"recipe path (phase 1, phase 2 from it, transfer): launches "
          f"{recipe_launches}")
    for fn in (fs.fused_ddim_sample, fm.fused_mel_unit_image,
               nm.normalized_mse_forward, ft.fused_trunk):
        check(recipe_launches[fn.__name__] > 0,
              f"{fn.__name__} never ran on the recipe path")
    results["launches"]["recipe_path"] = recipe_launches

    # the reference's own weights: import, then phase 2 from them
    ref = write_reference_weights(rdir / "reference", seed=7)
    cli.main(["import-torch", "--encoder", str(ref["encoder"]), "--decoder",
              str(ref["decoder"]), "--out", str(rdir / "ae_imported.pt")])
    cli.main(["import-torch", "--vggish", str(ref["vggish"]), "--out",
              str(rdir / "vggish_imported.pt")])
    reset_counts()
    cli.main(["train", "--model", "ldm", "--data-root", str(imgs),
              "--pairing-file", str(pairs_csv), "--epochs", "1",
              "--pretrained-ae", str(rdir / "ae_imported.pt"),
              "--style-features", str(rdir / "vggish_imported.pt"),
              "--out-dir", str(rdir / "ldm_imported")])
    import_launches = read_counts()
    imported = torch.load(rdir / "ldm_imported" / "ldm_final.pt",
                          map_location="cpu", weights_only=True)
    imp_params = load_autoencoder(rdir / "ae_imported.pt")["params"]
    same = all(torch.equal(imported["params"][f"encoder.{k}"], v)
               for k, v in imp_params["encoder"].items())
    print(f"import-torch (reference-layout encoder.pth / decoder.pth, "
          f"torchvggish vggish.pth), then train --model ldm --pretrained-ae "
          f"--style-features: step {imported['step']}, the imported encoder "
          f"kept bit for bit: {same}; launches {import_launches}")
    check(imported["step"] == 2 and same, "phase 2 from imported weights")
    check(import_launches["fused_trunk"] > 0, "the imported VGGish trunk "
          "never fed kernel E")
    results["launches"]["import_path"] = import_launches

    # kernel D on the phase-1 path: VGGish compression, f32, B=128, the
    # metric's weights the imported trunk's (AETrainer(feature_params=))
    cfg_ae = default_config()
    cfg_ae.train = dataclasses.replace(
        cfg_ae.train, compression_feature_extractor="vggish")
    vggish_imported = load_feature_checkpoint(rdir / "vggish_imported.pt")
    check(vggish_imported["kind"] == "vggish", "import-torch --vggish wrote "
          f"a {vggish_imported['kind']!r} checkpoint")
    ae_v = AETrainer(cfg_ae, feature_params=vggish_imported["params"])
    check(all(torch.equal(v.cpu(), vggish_imported["params"][k]) for k, v in
              ae_v.feature.module.state_dict().items()),
          "AETrainer(feature_params=) does not hold the imported trunk")
    state_ae_v = ae_v.init_state(0)
    reset_counts()
    ae_v_losses = []
    for _ in range(3):
        state_ae_v, loss = ae_v._step(state_ae_v, c128)
        ae_v_losses.append(loss.item())
    ae_path_launches = read_counts()
    d_per_step = {k: ae_path_launches[k] / 3 for k in (
        "normalized_mse_forward", "normalized_mse_backward")}
    print(f"AETrainer, VGGish compression (the imported trunk), B=128 "
          f"f32, 3 steps: losses "
          f"{ae_v_losses}; launches {ae_path_launches} (kernel D per step: "
          f"{d_per_step})")
    check(all(np.isfinite(ae_v_losses)), "the VGGish AE step gave a "
          "non-finite loss")
    check(ae_path_launches["normalized_mse_forward"] > 0
          and ae_path_launches["normalized_mse_backward"] > 0,
          "kernel D's forward and target-side backward must run on the "
          "phase-1 path")
    results["launches"]["ae_path"] = ae_path_launches

    # one f32 AE step at B=8: through the kernels vs the plain versions,
    # each under utils/profiling.py's debug_mode (it raises at a NaN or an
    # Inf in any module's output or in the backward)
    torch.backends.cudnn.deterministic = True
    ae_runs = {}
    for impl in ("auto", "plain"):
        tr = AETrainer(cfg_ae, feature_impl=impl)
        with debug_mode():
            st, loss = tr._step(tr.init_state(0), c8)
        ae_runs[impl] = (loss.item(), {k: p.grad for k, p in
                                       st.model.named_parameters()})
    torch.backends.cudnn.deterministic = False
    (lk, gk_ae), (lr_, gr_ae) = ae_runs["auto"], ae_runs["plain"]
    err_ae = {"loss": abs(lk - lr_) / abs(lr_),
              "grad_of_max": grad_err_of_max(gk_ae, gr_ae)}
    print(f"f32 AE step B=8 (VGGish compression, TF32 off, no NaN or Inf "
          f"under debug_mode): kernels vs "
          f"plain versions, loss rel {err_ae['loss']:.3g} (tol "
          f"{TOL_STEP_LOSS}), parameter gradients max abs / max "
          f"{err_ae['grad_of_max']:.3g} (tol {TOL_STEP_GRAD})")
    check(err_ae["loss"] <= TOL_STEP_LOSS
          and err_ae["grad_of_max"] <= TOL_STEP_GRAD,
          "the f32 AE step through the kernels disagrees with the plain "
          "versions")
    results["max_abs_err"]["f32_ae_step"] = err_ae

    # ---- 6c. the distillation and evaluation path ------------------------
    # a cascade and a guided collapse through cli distill at the defaults
    # (B=128, bf16, t_max 100) from phase 6's checkpoint, the students
    # served (cli transfer, HTTP) on their own grids, the evaluation
    # block on the card and cli diagnose; the launch counts read around
    # all of it.  The kernels are held against their plain versions at
    # this path's shapes after the counts are read.
    ddir = tdir / "distill"
    teacher32 = load_ldm(full_checkpoint=str(trained), dtype=torch.float32)
    teacher_sd = {k: v.cpu() for k, v in teacher32.state_dict().items()}
    # the teacher's weights alone (ldm_final.pt also holds Adam's state),
    # so that phase 7 times its transfer from a file the student's size
    save_checkpoint(ddir / "teacher.pt", teacher32)
    reset_counts()
    t0 = time.perf_counter()
    printed, _ = run_cli(cli, [
        "distill", "--checkpoint", str(trained), "--data-root", str(imgs),
        "--pairing-file", str(pairs_csv), "--stages", "96,48,24,12,6",
        "--steps-per-stage", "4", "--inflight-every", "2", "--out-dir",
        str(ddir / "cascade")])
    torch.cuda.synchronize()
    cli_distill_s = time.perf_counter() - t0
    check("--steps 100 --sample-steps 4" in printed,
          "cli distill's closing line does not name the student's grid")
    rows = (ddir / "cascade" / "distill_metrics.csv").read_text().splitlines()
    stage_rows = [dict(zip(rows[0].split(","), map(float, r.split(","))))
                  for r in rows[1:]]
    check(len(stage_rows) == 5 and all(
        np.isfinite(r["loss_head"]) and np.isfinite(r["loss_tail"])
        for r in stage_rows), "cli distill logged a non-finite loss")
    moved_unet, frozen_moved = [], []
    for n, stages_n in ((48, [96]), (24, [96, 48]), (12, [96, 48, 24]),
                        (6, [96, 48, 24, 12]), (3, [96, 48, 24, 12, 6])):
        payload = torch.load(ddir / "cascade" / f"distilled_{n}.pt",
                             map_location="cpu", weights_only=True)
        check(payload["distill"] == {"steps": n, "t_max": 100,
                                     "stages": stages_n, "guidance": 1.0},
              f"distilled_{n}.pt metadata {payload['distill']}")
        frozen_moved += [f"{n}:{k}" for k, v in payload["params"].items()
                         if not k.startswith("unet.")
                         and not torch.equal(v, teacher_sd[k])]
        moved_unet.append(any(not torch.equal(v, teacher_sd[k])
                              for k, v in payload["params"].items()
                              if k.startswith("unet.")))
    print(f"cli distill --stages 96,48,24,12,6 --steps-per-stage 4 (B=128, "
          f"bf16, t_max 100): {cli_distill_s:.2f} s wall; stages (head, "
          f"tail) {[(r['loss_head'], r['loss_tail']) for r in stage_rows]};"
          f" encoder, decoder, style encoder bit for bit the teacher's: "
          f"{not frozen_moved}; UNet moved in every checkpoint: "
          f"{all(moved_unet)}")
    check(not frozen_moved, f"distillation moved frozen weights: "
          f"{frozen_moved[:3]}")
    check(all(moved_unet), "a student's UNet did not move")
    check(not list((ddir / "cascade").glob("inflight_*")),
          "an in-flight save outlived its stage")
    printed, _ = run_cli(cli, [
        "distill", "--checkpoint", str(trained), "--data-root", str(imgs),
        "--pairing-file", str(pairs_csv), "--stages", "6,3", "--guidance",
        "2.0", "--steps-per-stage", "2", "--out-dir", str(ddir / "guided")])
    meta1 = torch.load(ddir / "guided" / "distilled_1.pt", map_location="cpu",
                       weights_only=True)["distill"]
    check(meta1 == {"steps": 1, "t_max": 100, "stages": [6, 3],
                    "guidance": 2.0}, f"distilled_1.pt metadata {meta1}")
    check("--steps 100 --sample-steps 2" in printed, "the guided cascade's "
          "closing line")
    d3 = ddir / "cascade" / "distilled_3.pt"
    d1 = ddir / "guided" / "distilled_1.pt"

    # the 3-step student served on its grid: the CLI (fused: kernels A
    # and C; ddim: B) and the HTTP server, which adopts the grid
    a_before = fs.fused_ddim_sample.launches
    t0 = time.perf_counter()
    _, err = run_cli(cli, [
        "transfer", "--checkpoint", str(d3), "--content", str(content_wav),
        "--style", str(imgs / "rock" / "000.png"), "--sampler", "fused",
        "--steps", "100", "--sample-steps", "4", "--overlap", "0.5",
        "--output", str(ddir / "student_transfer")])
    torch.cuda.synchronize()
    student_transfer_s = time.perf_counter() - t0
    a_transfer = fs.fused_ddim_sample.launches - a_before
    png = read_png_gray((ddir / "student_transfer.png").read_bytes())
    sr_out, audio = wavfile.read(ddir / "student_transfer.wav")
    check(png.shape == (128, 128 * n_chunks) and sr_out == 22050
          and bool(np.isfinite(audio).all()), "the student's cli transfer")
    check("distilled for" not in err, "cli transfer warned on the student's "
          "own grid")
    check(a_transfer == -(-n_chunks // 8), f"kernel A ran {a_transfer} "
          f"times for {n_chunks} chunks")
    _, err7 = run_cli(cli, [
        "transfer", "--checkpoint", str(d3), "--content",
        str(imgs / "classic" / "000.png"), "--style",
        str(imgs / "rock" / "000.png"), "--sampler", "fused", "--steps",
        "100", "--sample-steps", "7", "--output",
        str(ddir / "student_off_grid")])
    check("WARNING: checkpoint was distilled for --steps 100 --sample-steps 4"
          in err7, "cli transfer did not warn off the student's grid")
    b_before = fused_ddim_update.launches
    run_cli(cli, [
        "transfer", "--checkpoint", str(d3), "--content",
        str(imgs / "classic" / "000.png"), "--style",
        str(imgs / "rock" / "000.png"), "--sampler", "ddim", "--steps",
        "100", "--sample-steps", "4", "--output",
        str(ddir / "student_ddim")])
    b_transfer = fused_ddim_update.launches - b_before
    check(b_transfer == 3, f"the 3-step student's scan DDIM ran kernel B "
          f"{b_transfer} times")
    serve_args = cli.build_parser().parse_args(
        ["serve", "--checkpoint", str(d3), "--sampler", "fused"])
    student_engine = cli.build_engines(serve_args)["default"]
    cfg_e = student_engine.config
    check(cfg_e.steps == 100 and cfg_e.sample_steps == 4, f"the server "
          f"serves the student at steps {cfg_e.steps} sample_steps "
          f"{cfg_e.sample_steps}, not its grid (100, 4)")
    httpd = serve(student_engine, host="127.0.0.1", port=0, block=False)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/transfer",
            data=json.dumps(bodies["transfer"]).encode(),
            headers={"Content-Type": "application/json"})
        a_before = fs.fused_ddim_sample.launches
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body = resp.status, json.loads(resp.read())
        student_http_s = time.perf_counter() - t0
        a_http = fs.fused_ddim_sample.launches - a_before
        png = read_png_gray(base64.b64decode(body["image_png_b64"]))
        sr_out, audio = wavfile.read(io.BytesIO(
            base64.b64decode(body["audio_wav_b64"])))
        check(status == 200 and png.shape == (128, 128)
              and audio.shape == (66150,)
              and bool(np.isfinite(audio).all()), "HTTP /v1/transfer of the "
              "student")
        check(a_http == 1, f"one request ran kernel A {a_http} times")
    finally:
        httpd.shutdown()
        httpd.server_close()
        student_engine.stop()
    print(f"the 3-step student: cli transfer (9 s, fused, --steps 100 "
          f"--sample-steps 4) {student_transfer_s:.2f} s, {a_transfer} A "
          f"launch(es), no warning; --sample-steps 7 warns; --sampler ddim "
          f"{b_transfer} B launches; HTTP /v1/transfer on the adopted grid "
          f"(steps {cfg_e.steps}, sample_steps {cfg_e.sample_steps}) "
          f"{student_http_s:.3f} s, {a_http} A launch")

    # evaluation: the teacher's full grid, the teacher and the student on
    # the student's 4-point grid, B=8 seeded pairs, bf16 (the served type)
    t_eval = time.perf_counter()
    ev_content = np.stack([load_image_unit(imgs / "classic" / f"{i:03d}.png")
                           for i in range(8)])
    ev_style = np.stack([load_image_unit(imgs / "rock" / f"{i:03d}.png")
                         for i in range(8)])
    ev_c, ev_s = torch.as_tensor(ev_content), torch.as_tensor(ev_style)
    teacher16 = load_ldm(full_checkpoint=str(trained))
    student16 = load_ldm(full_checkpoint=str(d3))
    outs_ev = {name: fs.fused_content_style_transfer(
        m, ev_c, ev_s, num_timesteps=100, steps=steps,
        seeds=np.arange(8)).float().cpu().numpy()
        for name, m, steps in (("teacher_100", teacher16, None),
                               ("teacher_coarse", teacher16, 4),
                               ("student", student16, 4))}
    fidelity = {}
    for name in ("teacher_coarse", "student"):
        mse = float(np.mean((outs_ev[name] - outs_ev["teacher_100"]) ** 2))
        fidelity[name] = {"mse_vs_teacher_100": mse,
                          "psnr_db": 10 * np.log10(1.0 / max(mse, 1e-12))}
    e_d_before = (ft.fused_trunk.launches,
                  nm.normalized_mse_forward.launches)
    t_metrics = time.perf_counter()
    eval_metrics = independent_transfer_metrics(ev_content, ev_style,
                                                outs_ev["student"])
    torch.cuda.synchronize()
    eval_metrics_s = time.perf_counter() - t_metrics
    eval_block_s = time.perf_counter() - t_eval
    e_eval = ft.fused_trunk.launches - e_d_before[0]
    d_eval = nm.normalized_mse_forward.launches - e_d_before[1]
    print(f"evaluation, B=8 (bf16, fused): pixel MSE / PSNR against the "
          f"teacher's 99-step transfer {fidelity}; independent_transfer_"
          f"metrics of the student on the card {eval_metrics}; kernel E "
          f"launches {e_eval}, kernel D forward launches {d_eval}; block "
          f"{eval_block_s:.2f} s (metrics {eval_metrics_s:.2f} s)")
    # two seeds, two distances each: one E launch per distance, with D's
    # forward once per trunk layer inside it
    check(e_eval == 4 and d_eval == 4 * 6, f"the evaluation's distances ran"
          f" kernel E {e_eval} and D {d_eval} times, not 4 and 24")
    check(all(np.isfinite(v) for v in eval_metrics[
        "vggish_multiseed_style_reduction_pct"].values())
        and np.isfinite(eval_metrics["fad_transfer_vs_style_corpus"]),
        "the evaluation metrics are not finite")

    printed, _ = run_cli(cli, ["diagnose", "--checkpoint", str(d3)])
    n_params = sum(p.numel() for p in build_ldm(device=dev).parameters())
    total_line = next(ln for ln in printed.splitlines()
                      if ln.split()[:1] == ["total"])
    check(int(total_line.split()[1].replace(",", "")) == n_params,
          f"cli diagnose: {total_line.strip()} against {n_params} "
          "parameters")
    check("DEAD" not in printed, "cli diagnose flagged a level of a random "
          "style encoder dead")
    distill_launches = read_counts()
    print(f"distillation and evaluation path: launches {distill_launches}")
    for fn in counted:
        if fn is not nm.normalized_mse_backward:   # distances: value only
            check(distill_launches[fn.__name__] > 0,
                  f"{fn.__name__} never ran on the distillation and "
                  "evaluation path")
    results["launches"]["distill"] = distill_launches

    # the path's kernels against their plain versions at its shapes:
    # kernel A on the students' short grids (3 steps: distilled_3; 1 step:
    # distilled_1), f32 and bf16, B = 1 and 8, DDIM and DPM++(2M)
    err_short = {}
    for path_s, n_s in ((d3, 3), (d1, 1)):
        for dt in (torch.float32, torch.bfloat16):
            ldm_s = load_ldm(full_checkpoint=str(path_s), dtype=dt)
            for B in (1, 8):
                for sampler in ("ddim", "dpm++"):
                    ops, z_t, n = packed(ldm_s, B, sampler, steps=n_s + 1,
                                         t_max=100)
                    check(n == n_s and ops.coefs.shape[0] == n_s,
                          f"a {n_s}-step grid packed {n} steps")
                    k = fs.fused_ddim_sample(ops, z_t, n)
                    r = fs.reference_ddim_sample(ops, z_t, n)
                    if dt == torch.float32:
                        err = (k - r).abs().max().item()
                        tol = TOL_KERNEL_A
                    else:
                        err = (ldm_s.decode_unit(k.permute(0, 3, 1, 2))
                               - ldm_s.decode_unit(r.permute(0, 3, 1, 2))
                               ).abs().max().item()
                        tol = TOL_KERNEL_A_BF16
                    key = f"{n_s} steps {str(dt)[6:]} B={B} {sampler}"
                    err_short[key] = err
                    check(bool(torch.isfinite(k).all()) and err <= tol,
                          f"kernel A on a {n_s}-step grid ({key}): max abs "
                          f"err {err:.3g} (tol {tol})")
            del ldm_s
    print(f"kernel A vs plain on the students' grids (f32: latents, tol "
          f"{TOL_KERNEL_A}; bf16: decoded, tol {TOL_KERNEL_A_BF16}): "
          f"{ {k: float(f'{v:.3g}') for k, v in err_short.items()} }")
    # kernels E (f32 value-only) and D inside the evaluation's distances
    raw = {impl: style_distances_multiseed(ev_content, ev_style,
                                           outs_ev["student"], impl=impl)
           for impl in ("auto", "plain")}
    err_eval_e = max(abs(a - b) / b for seed in raw["plain"] for a, b in
                     zip(raw["auto"][seed], raw["plain"][seed]))
    emb_card = trunk_embeddings(ev_content, seed=11)
    emb_cpu = trunk_embeddings(ev_content, seed=11, device="cpu")
    err_embed = float(np.abs(emb_card - emb_cpu).max()
                      / np.abs(emb_cpu).max())
    print(f"evaluation's VGGish distances (seeds 11, 29; d(content, style), "
          f"d(student, style)): kernels E f32 value-only + D {raw['auto']}, "
          f"plain {raw['plain']}: max rel err {err_eval_e:.3g} (tol "
          f"{TOL_E_VALUE}); trunk_embeddings card vs CPU max abs / max "
          f"{err_embed:.3g} (tol {TOL_EMBED})")
    check(err_eval_e <= TOL_E_VALUE, "kernel E (f32 value-only) disagrees "
          "with the plain version in the evaluation's distances")
    check(err_embed <= TOL_EMBED, "trunk_embeddings on the card disagree "
          "with the CPU")
    results["max_abs_err"]["distill_path"] = {
        "kernel_a_short_grids": err_short, "eval_vggish_rel": err_eval_e,
        "trunk_embeddings_of_max": err_embed}
    results["distill"] = {
        "cli_distill_s": cli_distill_s, "stages": stage_rows,
        "student_transfer_s": student_transfer_s,
        "student_http_s": student_http_s, "fidelity": fidelity,
        "eval_metrics": eval_metrics, "eval_block_s": eval_block_s,
        "eval_metrics_s": eval_metrics_s}
    del teacher16, student16

    # ---- 7. times -------------------------------------------------------
    times: dict = {"kernel_a_ms": {}, "plain_a_ms": {}, "scan_route_ms": {},
                   "bound_a_ms": {}, "engine_request_s": {},
                   "scan_engine_request_s": {}, "kernel_a_f32_ms": {}}
    for B in (1, 2, 4, 8):
        ops, z_t, n = packed(ldm, B)
        emb = ldm.style_encoder(style[:B].permute(0, 3, 1, 2).bfloat16())
        z_nchw = z_t.permute(0, 3, 1, 2)
        grid = transfer_time_grid(50)
        times["kernel_a_ms"][B] = cuda_ms(
            lambda: fs.fused_ddim_sample(ops, z_t, n), 20)
        times["plain_a_ms"][B] = cuda_ms(
            lambda: fs.reference_ddim_sample(ops, z_t, n), 2)
        times["scan_route_ms"][B] = cuda_ms(
            lambda: ddim_sample(lambda z, t: ldm.unet(z, t, emb).float(),
                                ldm.schedule, z_nchw, grid), 3)
        cost = fs.trajectory_cost(ops, n)
        times["bound_a_ms"][B] = 1e3 * max(cost["flops"] / H100_BF16_FLOPS,
                                           cost["bytes"] / H100_BYTES)
        print(f"time {card} B={B}, {n} steps, bf16: kernel A "
              f"{times['kernel_a_ms'][B]:.3f} ms/trajectory "
              f"({1e3 * times['kernel_a_ms'][B] / n:.1f} us/step), plain "
              f"version {times['plain_a_ms'][B]:.3f} ms, scan route "
              f"{times['scan_route_ms'][B]:.3f} ms, bound "
              f"{times['bound_a_ms'][B]:.4f} ms ({cost['flops'] / 1e9:.2f} "
              f"GFLOP, {cost['bytes'] / 1e6:.2f} MB)")
    for B in (1, 8):    # the f32 instance: a parity instrument
        ops, z_t, n = packed(ldm32, B)
        times["kernel_a_f32_ms"][B] = cuda_ms(
            lambda: fs.fused_ddim_sample(ops, z_t, n), 3)
        print(f"time {card} B={B}, {n} steps, f32: kernel A "
              f"{times['kernel_a_f32_ms'][B]:.3f} ms/trajectory")
    faster = [B for B in times["kernel_a_ms"]
              if times["kernel_a_ms"][B] < times["scan_route_ms"][B]]
    print(f"kernel A beats the scan route at buckets {faster}; the engine "
          f"routes buckets <= {engine.fused_bucket_max} to it")
    check(all(B in faster for B in times["kernel_a_ms"]
              if B <= engine.fused_bucket_max),
          "kernel A is slower than the scan route at a bucket routed to it")
    # kernel A on the students' grids (t_max 100: 6, 3 and 1 steps), bf16,
    # beside its 49-step time at the same batch and the bound of each
    times["kernel_a_short"] = {}
    for n_s in (6, 3, 1):
        for B in (1, 8):
            ops, z_t, n = packed(ldm, B, steps=n_s + 1, t_max=100)
            cost = fs.trajectory_cost(ops, n)
            r = times["kernel_a_short"][f"{n_s}_steps_b{B}"] = {
                "ms": cuda_ms(lambda: fs.fused_ddim_sample(ops, z_t, n), 50),
                "bound_ms": 1e3 * max(cost["flops"] / H100_BF16_FLOPS,
                                      cost["bytes"] / H100_BYTES)}
            print(f"time {card} B={B}, {n} step(s), bf16: kernel A "
                  f"{r['ms']:.3f} ms/trajectory ({1e3 * r['ms'] / n:.1f} "
                  f"us/step; 49 steps: {times['kernel_a_ms'][B]:.3f} ms, "
                  f"{1e3 * times['kernel_a_ms'][B] / 49:.1f} us/step), bound "
                  f"{r['bound_ms']:.5f} ms")
    ab49, ab48 = float(ab[49]), float(ab[48])
    xb = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    eb = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    nb = xb.numel()
    kb_out_ms = cuda_ms(lambda: fused_ddim_update(xb, eb, ab49, ab48, 0.0),
                        200)
    print(f"time {card} kernel B [8,16,16,32] f32, fused_ddim_update (out of "
          f"place, no caller in the port): {kb_out_ms * 1e3:.2f} us/launch "
          f"back to back, bound {1e6 * 12 * nb / H100_BYTES:.3f} us (bytes)")
    # The sampler's entry: in place, eps in the UNet's own type (bf16 on
    # the main path's engines).  Bound: x read and written and eps read
    # once; its 6 flops per element take less than the bytes.
    times["kernel_b_detail"] = {}
    sc49 = step_scalars(ab49, ab48, 0.0)
    for eps_type, ee in (("f32", eb), ("bf16", eb.bfloat16())):
        xw = xb.clone()
        r = times["kernel_b_detail"][eps_type] = {
            "back_to_back_us": 1e3 * cuda_ms(
                lambda: ddim_update_(xw, ee, sc49), 200),
            "device_us": device_us(lambda: ddim_update_(xw, ee, sc49),
                                   "ddim_update"),
            "host_us": host_us(lambda: ddim_update_(xw, ee, sc49)),
            "plain_us": 1e3 * cuda_ms(
                lambda: ddim_step_reference(xw, ee, sc49), 200),
            "bound_us": 1e6 * max(nb * (8 + ee.element_size()) / H100_BYTES,
                                  6 * nb / H100_F32_FLOPS)}
        print(f"time {card} kernel B [8,16,16,32] ddim_update_ (in place, "
              f"the sampler's entry), eps {eps_type}: "
              f"{r['back_to_back_us']:.2f} us/launch back to back, device "
              f"{r['device_us']:.3f} us per launch (torch.profiler), host "
              f"{r['host_us']:.2f} us per call (1,000 calls, no sync); plain "
              f"version {r['plain_us']:.2f} us, bound {r['bound_us']:.3f} us "
              f"(bytes)")
        del xw
    kb = times["kernel_b_detail"]["bf16"]
    kb_ms, pb_ms, bound_b_ms = (kb["back_to_back_us"] / 1e3,
                                kb["plain_us"] / 1e3, kb["bound_us"] / 1e3)
    for B in engine.config.batch_buckets:
        t0 = time.perf_counter()
        engine.transfer_batch(reqs_c[:B], reqs_s[:B], seeds=np.arange(B))
        times["engine_request_s"][B] = time.perf_counter() - t0
        route = "fused" if engine.uses_fused(B) else "scan"
        t0 = time.perf_counter()
        scan_engine.transfer_batch(reqs_c[:B], reqs_s[:B], seeds=np.arange(B))
        times["scan_engine_request_s"][B] = time.perf_counter() - t0
        print(f"time {card} engine transfer_batch B={B} ({route} route, 50 "
              f"steps, NNLS 64, GL 32): {times['engine_request_s'][B]:.3f} "
              f"s; scan-route engine {times['scan_engine_request_s'][B]:.3f}"
              " s")
    times.update({"kernel_c_ms": {}, "plain_c_ms": {}, "bound_c_ms": {},
                  "front_end_ms_per_chunk": {}, "bound_c_by": {}})
    for B in (1, 8):
        S = spectra[("waveform", B)]
        times["kernel_c_ms"][B] = cuda_ms(
            lambda: fm.fused_mel_unit_image(fb, S), 50)
        times["plain_c_ms"][B] = cuda_ms(
            lambda: fm.fused_mel_unit_image_reference(fb, S), 50)
        # bound: the work this filterbank needs (each row's band); the
        # dense count is printed beside it
        band = fm.mel_image_band_cost(fb, 130, B)
        cost = fm.mel_image_cost(128, 1025, 130, B)
        bound = {"operations": band["flops"] / H100_F32_FLOPS,
                 "bytes": band["bytes"] / H100_BYTES}
        times["bound_c_ms"][B] = 1e3 * max(bound.values())
        bound_c_by = times["bound_c_by"][B] = max(bound, key=bound.get)
        times.setdefault("dense_bound_c_ms", {})[B] = 1e3 * max(
            cost["flops"] / H100_F32_FLOPS, cost["bytes"] / H100_BYTES)
        times.setdefault("kernel_c_device_us", {})[B] = device_us(
            lambda: fm.fused_mel_unit_image(fb, S), "mel_unit_image")
        times.setdefault("kernel_c_host_us", {})[B] = host_us(
            lambda: fm.fused_mel_unit_image(fb, S))
        chunks = 0.3 * torch.randn(B, 66150, device=dev, generator=g)
        times["front_end_ms_per_chunk"][B] = cuda_ms(
            lambda: ap.waveform_batch_to_unit_images(chunks), 50) / B
        print(f"time {card} kernel C [{B},1025,130] f32: "
              f"{times['kernel_c_ms'][B] * 1e3:.1f} us/launch back to back, "
              f"device {times['kernel_c_device_us'][B]:.2f} us per launch "
              f"(torch.profiler), host {times['kernel_c_host_us'][B]:.2f} us "
              f"per call (1,000 calls, no sync); plain version "
              f"{times['plain_c_ms'][B] * 1e3:.1f} us, bound "
              f"{times['bound_c_ms'][B] * 1e3:.3f} us ({bound_c_by}; "
              f"band-limited {band['flops'] / 1e6:.3f} MFLOP, "
              f"{band['bytes'] / 1e6:.3f} MB; dense "
              f"{cost['flops'] / 1e6:.1f} MFLOP, {cost['bytes'] / 1e6:.2f} "
              f"MB, {times['dense_bound_c_ms'][B] * 1e3:.3f} us); front end "
              f"(STFT + kernel C) "
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
    # the 3-step student's cli transfer beside its teacher's 99-step one:
    # same clip and arguments, checkpoints of one size, in turns
    transfer_args = ["--content", str(content_wav), "--style",
                     str(imgs / "rock" / "000.png"), "--sampler", "fused",
                     "--steps", "100", "--overlap", "0.5"]
    wall: dict = {"teacher_99_steps": [], "student_3_steps": []}
    for name in ("teacher_99_steps", "student_3_steps", "student_3_steps",
                 "teacher_99_steps"):
        ckpt_t, extra = ((ddir / "teacher.pt", []) if name.startswith("t")
                         else (d3, ["--sample-steps", "4"]))
        t0 = time.perf_counter()
        run_cli(cli, ["transfer", "--checkpoint", str(ckpt_t),
                      *transfer_args, *extra, "--output",
                      str(ddir / f"timed_{name}")])
        torch.cuda.synchronize()
        wall[name].append(time.perf_counter() - t0)
    times["distill_cli_transfer_s"] = wall
    times["eval_block_s"] = {"block": eval_block_s,
                             "independent_transfer_metrics": eval_metrics_s}
    print(f"time {card} cli transfer, {content_wav.name} (9 s, {n_chunks} "
          f"chunks, fused, --steps 100, overlap 0.5; runs teacher, student, "
          f"student, teacher): teacher (99 steps) "
          f"{[round(x, 3) for x in wall['teacher_99_steps']]} s wall, "
          f"3-step student (--sample-steps 4) "
          f"{[round(x, 3) for x in wall['student_3_steps']]} s; evaluation "
          f"block (three B=8 transfers and the metrics) {eval_block_s:.2f} "
          f"s, independent_transfer_metrics {eval_metrics_s:.2f} s")
    # kernel D: layer 1 of VGGish, bf16, B=128 (p16, t16 from phase 3)
    kd_ms = cuda_ms(lambda: nm.normalized_mse_forward(p16, t16), 20)
    pd_ms = cuda_ms(lambda: nm.normalized_mse_forward_reference(p16, t16), 5)
    _, st16 = nm.normalized_mse_forward(p16, t16)
    us16 = torch.full((128,), 1.0 / 128, device=dev)
    kdb_ms = cuda_ms(lambda: nm.normalized_mse_backward(
        p16, t16, st16, us16, False), 20)
    pdb_ms = cuda_ms(lambda: nm.normalized_mse_backward_reference(
        p16, t16, st16, us16, False), 5)
    cost = nm.normalized_mse_cost(128, p16[0].numel(), 2)
    bound_d = {"bytes": cost["bytes"] / H100_BYTES,
               "operations": cost["flops"] / H100_F32_FLOPS}
    bound_d_ms = 1e3 * max(bound_d.values())
    bound_d_by = max(bound_d, key=bound_d.get)
    # backward (dp): p and t read once, dp written once (bf16), the
    # statistics and upstream scales; 10 operations per element
    bwd_bytes = 3 * p16.numel() * 2 + 20 * 128
    bound_d_bwd = {"bytes": bwd_bytes / H100_BYTES,
                   "operations": 10 * p16.numel() / H100_F32_FLOPS}
    bound_d_bwd_ms = 1e3 * max(bound_d_bwd.values())
    print(f"time {card} kernel D [128,128,128,64] bf16: forward "
          f"{kd_ms:.3f} ms/call, plain version {pd_ms:.3f} ms; backward (dp) "
          f"{kdb_ms:.3f} ms, plain {pdb_ms:.3f} ms; forward bound "
          f"{bound_d_ms:.4f} ms ({bound_d_by}: {cost['bytes'] / 1e6:.1f} MB),"
          f" backward bound {bound_d_bwd_ms:.4f} ms "
          f"({max(bound_d_bwd, key=bound_d_bwd.get)}: {bwd_bytes / 1e6:.1f} "
          "MB)")
    times.update({"kernel_d_ms": kd_ms, "plain_d_ms": pd_ms,
                  "kernel_d_bwd_ms": kdb_ms, "plain_d_bwd_ms": pdb_ms,
                  "bound_d_ms": bound_d_ms, "bound_d_by": bound_d_by,
                  "bound_d_bwd_ms": bound_d_bwd_ms})
    del p16, t16
    # kernel E: the trunk from f1, bf16, B=8 and B=128
    times.update({"kernel_e_ms": {}, "plain_e_ms": {}, "bound_e_ms": {}})
    for B in (8, 128):
        pb = torch.rand(B, 128, 128, 1, device=dev, generator=g)
        f1 = ft.conv1_both(vgg16, pb, pb.flip(0))
        for grad in (False, True):
            key = f"{'grad' if grad else 'value'}_b{B}"
            times["kernel_e_ms"][key] = cuda_ms(
                lambda: ft.fused_trunk(vgg16, f1, grad), 5)
            times["plain_e_ms"][key] = cuda_ms(
                lambda: ft.fused_trunk_reference(vgg16, f1, grad), 3)
            cost = ft.trunk_cost(vgg16, B, 128, 128, 2, grad)
            times["bound_e_ms"][key] = 1e3 * max(
                cost["flops"] / H100_BF16_FLOPS, cost["bytes"] / H100_BYTES)
            print(f"time {card} kernel E {'with grad' if grad else 'value'} "
                  f"B={B} bf16 128x128: {times['kernel_e_ms'][key]:.3f} "
                  f"ms/call, plain version {times['plain_e_ms'][key]:.3f} "
                  f"ms, bound {times['bound_e_ms'][key]:.4f} ms (operations: "
                  f"{cost['flops'] / 1e12:.3f} TFLOP at 989 TFLOP/s)")
        del f1
    # E's yardstick: the trunk's five convs as cuDNN bf16 calls (phase 3)
    e_library_ms = sum(r["cudnn_fwd_ms"] for r in convs.values())
    times["trunk_convs_b128"] = convs
    times["library_e_ms"] = e_library_ms
    print(f"time {card} kernel E value B=128: the cuDNN chain of its five "
          f"convs (bf16, channels_last) {e_library_ms:.3f} ms; the kernel's "
          f"five convs {sum(r['fwd_ms'] for r in convs.values()):.3f} ms")
    # kernel E f32 value-only at the evaluation batch (B=8, 128x128, a
    # seed-11 trunk as the evaluation builds it); bound: its convs'
    # operations at the f32 rate (CUDA cores)
    vgg_eval = build_feature_metric("vggish", torch.float32, seed=11).module
    f1e = ft.conv1_both(vgg_eval, ev_c.to(dev), ev_s.to(dev))
    cost = ft.trunk_cost(vgg_eval, 8, 128, 128, 4, False)
    w8e = torch.ones(8, device=dev)
    times["kernel_e_eval_f32"] = r = {
        "ms": cuda_ms(lambda: ft.fused_trunk(vgg_eval, f1e, False), 5),
        "plain_ms": cuda_ms(lambda: ft.fused_trunk_reference(
            vgg_eval, f1e, False), 5),
        "distance_ms": cuda_ms(lambda: ft.fused_vggish_distance_value(
            vgg_eval, ev_c.to(dev), ev_s.to(dev), w8e), 5),
        "bound_ms": 1e3 * max(cost["flops"] / H100_F32_FLOPS,
                              cost["bytes"] / H100_BYTES)}
    print(f"time {card} kernel E f32 value B=8 128x128 (the evaluation's "
          f"distance): {r['ms']:.3f} ms/call, plain version "
          f"{r['plain_ms']:.3f} ms, the whole value call (conv1, E, D) "
          f"{r['distance_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
          f"(operations: {cost['flops'] / 1e12:.4f} TFLOP at 67 TFLOP/s)")
    del f1e
    # the training step at B=128, bf16, defaults
    trainer_t = LDMTrainer(default_config())
    state_t = trainer_t.init_state(0)
    state_t, _ = trainer_t._step(state_t, c128, s128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state_t, _ = trainer_t._step(state_t, c128, s128)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    step_mem = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    for _ in range(3):
        state_v, _ = trainer_v._step(state_v, c128, s128)
    torch.cuda.synchronize()
    step_v_ms = 1e3 * (time.perf_counter() - t0) / 3
    print(f"time {card} training step B=128 bf16 (defaults: E value-only "
          f"style term, LPIPS compression): {step_ms:.1f} ms/step, "
          f"{1e3 / step_ms:.2f} steps/s, peak memory {step_mem:.0f} MiB; "
          f"style gradient on + VGGish compression (E with grad, D layer "
          f"route): {step_v_ms:.1f} ms/step")
    times.update({"train_step_ms": step_ms, "train_steps_per_s":
                  1e3 / step_ms, "train_step_peak_mib": step_mem,
                  "train_step_variant_ms": step_v_ms,
                  "cli_train_s": cli_train_s})
    # where one default step's device time goes
    kernels_us = profiled_kernels(
        lambda: trainer_t._step(state_t, c128, s128),
        work / "profile" / "ldm_step")
    # E: conv3x3_wgmma_kernel (bf16), conv3x3_kernel (f32), the pools;
    # D: nm_forward_kernel, nm_backward_kernel
    groups = {"E (trunk kernels)": ("conv3x3_wgmma_kernel", "conv3x3_kernel",
                                    "maxpool2_kernel", "unpool2_kernel"),
              "D (normalized MSE)": ("nm_forward_kernel",
                                     "nm_backward_kernel")}
    by_group: dict = {}
    device_total = 0.0
    for dev_us, key in kernels_us:
        device_total += dev_us
        name = next((gname for gname, keys in groups.items()
                     if any(k in key for k in keys)), "other")
        by_group[name] = by_group.get(name, 0.0) + dev_us
    print(f"profile {card} one training step B=128 bf16: device time "
          f"{device_total / 1e3:.2f} ms; by group (ms) "
          f"{ {k: round(v / 1e3, 2) for k, v in by_group.items()} }; top "
          f"kernels (ms) "
          f"{[(k[:60], round(v / 1e3, 2)) for v, k in kernels_us[:8]]}")
    times["train_step_profile"] = {"device_ms": device_total / 1e3,
                                   "groups_ms": {k: v / 1e3 for k, v in
                                                 by_group.items()},
                                   "top_kernels_ms": [
                                       (k, v / 1e3) for v, k in
                                       kernels_us[:12]]}
    # the distill step at B=128, bf16, factor 2 (the default cascade's
    # first stage, 96 -> 48), unguided and guided (a doubled-batch teacher
    # call): host clock over 5 steps ending in a synchronise, device time
    # from one profiled step, idle share, peak memory
    times["distill_step"] = {}
    dist = ProgressiveDistiller(default_config())
    for tag, gd in (("unguided", 1.0), ("guided", 2.0)):
        student_t = copy.deepcopy(teacher32)
        student_t.unet.requires_grad_(True)
        stage_t = dist.start_stage(student_t, 0, 96, 48, 1e-4, gd)
        box = [0]

        def distill_step():
            dist.step(student_t, stage_t, c128, s128, 0, box[0])
            box[0] += 1
        distill_step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            distill_step()
        torch.cuda.synchronize()
        r = times["distill_step"][tag] = {
            "ms": 1e3 * (time.perf_counter() - t0) / 5,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        d_kernels = profiled_kernels(distill_step,
                                     work / "profile" / f"distill_{tag}")
        r["device_ms"] = sum(us for us, _ in d_kernels) / 1e3
        r["idle_share"] = 1.0 - r["device_ms"] / r["ms"]
        r["top_kernels_ms"] = [(k, us / 1e3) for us, k in d_kernels[:6]]
        print(f"time {card} distill step B=128 bf16 factor 2 ({tag}): "
              f"{r['ms']:.1f} ms/step (host clock over 5 steps), device "
              f"{r['device_ms']:.2f} ms (torch.profiler), idle share "
              f"{r['idle_share']:.3f}, peak memory {r['peak_mib']:.0f} MiB; "
              f"top kernels (ms) "
              f"{[(k[:50], round(v, 2)) for k, v in r['top_kernels_ms']]}")
        del student_t, stage_t
    # the AE step at B=128, f32 (TF32 off inside the step, as in phase
    # 6b), LPIPS and VGGish compression: host clock per step, each ending
    # in a synchronise (StepTimer, mean and p95 of 5), device time from one
    # profiled step, the idle share (1 - device / host-clock time), peak
    # memory
    times["ae_step"] = {}
    for kind_ae in ("lpips", "vggish"):
        cfg_t = default_config()
        cfg_t.train = dataclasses.replace(
            cfg_t.train, compression_feature_extractor=kind_ae)
        tr = AETrainer(cfg_t)
        box = [tr._step(tr.init_state(0), c128)[0]]   # warm-up step

        def ae_step():
            box[0], _ = tr._step(box[0], c128)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timer = StepTimer()
        for _ in range(5):
            with timer:
                ae_step()
                torch.cuda.synchronize()
        steps = timer.summary()
        r = times["ae_step"][kind_ae] = {
            "ms": 1e3 * steps["mean_s"], "p95_ms": 1e3 * steps["p95_s"],
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        ae_kernels = profiled_kernels(ae_step,
                                      work / "profile" / f"ae_step_{kind_ae}")
        r["device_ms"] = sum(us for us, _ in ae_kernels) / 1e3
        r["idle_share"] = 1.0 - r["device_ms"] / r["ms"]
        r["top_kernels_ms"] = [(k, us / 1e3) for us, k in ae_kernels[:6]]
        print(f"time {card} AE step B=128 f32 ({kind_ae} compression): "
              f"{r['ms']:.1f} ms/step (host clock, mean of 5; p95 "
              f"{r['p95_ms']:.1f}), device "
              f"{r['device_ms']:.2f} ms (torch.profiler), idle share "
              f"{r['idle_share']:.3f}, peak memory {r['peak_mib']:.0f} MiB; "
              f"top kernels (ms) "
              f"{[(k[:50], round(v, 2)) for k, v in r['top_kernels_ms']]}")
        del tr, box
    # kernel D in f32 at layer 1, B=128 (the phase-1 VGGish compression
    # term: the forward, and the backward to the target); the bound counts
    # each map read once and the gradient written once, as the kernels do
    p32 = torch.relu(torch.randn(128, 128, 128, 64, device=dev,
                                 generator=g))
    t32 = torch.relu(torch.randn(128, 128, 128, 64, device=dev,
                                 generator=g))
    n32 = p32[0].numel()
    us32 = torch.full((128,), 1.0 / 128, device=dev)
    # held against the plain versions on the same maps first: m to
    # TOL_D_VALUE, the statistics to TOL_D_STATS of each column's max, and
    # the target gradient to TOL_D_GRAD of its max (with upstream 1 / B
    # every element lies below phase 3's atol, so the bar is on the max)
    m32, st32 = nm.normalized_mse_forward(p32, t32)
    m32r, st32r = nm.normalized_mse_forward_reference(p32, t32)
    dt32 = nm.normalized_mse_backward(p32, t32, st32, us32, True)
    dt32r = nm.normalized_mse_backward_reference(p32, t32, st32, us32, True)
    err_d32 = {
        "m": ((m32 - m32r).abs() / m32r.abs()).max().item(),
        "stats_of_max": ((st32 - st32r).abs().max(0).values
                         / st32r.abs().max(0).values).tolist(),
        "dt_of_max": ((dt32 - dt32r).abs().max()
                      / dt32r.abs().max()).item()}
    del m32, m32r, st32r, dt32, dt32r
    print(f"kernel D vs plain f32 [128,128,128,64] (phase 1's layer 1): m "
          f"rel {err_d32['m']:.3g} (tol {TOL_D_VALUE}), statistics max abs "
          f"error / column max "
          f"{[float(f'{e:.3g}') for e in err_d32['stats_of_max']]} (tol "
          f"{TOL_D_STATS}), target gradient max abs error / max "
          f"{err_d32['dt_of_max']:.3g} (tol {TOL_D_GRAD})")
    check(err_d32["m"] <= TOL_D_VALUE
          and max(err_d32["stats_of_max"]) <= TOL_D_STATS
          and err_d32["dt_of_max"] <= TOL_D_GRAD,
          "kernel D (f32, B=128, layer 1) disagrees with its plain version")
    results["max_abs_err"]["kernel_d_f32_b128"] = err_d32
    d32 = {"fwd_ms": cuda_ms(lambda: nm.normalized_mse_forward(p32, t32),
                             20),
           "plain_fwd_ms": cuda_ms(
               lambda: nm.normalized_mse_forward_reference(p32, t32), 5),
           "bwd_ms": cuda_ms(lambda: nm.normalized_mse_backward(
               p32, t32, st32, us32, True), 20),
           "plain_bwd_ms": cuda_ms(lambda: nm.normalized_mse_backward_reference(
               p32, t32, st32, us32, True), 5)}
    fwd_bytes = nm.normalized_mse_cost(128, n32, 4)["bytes"]
    bwd_bytes = 3 * 128 * n32 * 4 + (4 * nm.N_STATS + 4) * 128
    d32["bound_fwd_ms"] = 1e3 * max(fwd_bytes / H100_BYTES,
                                    10 * 128 * n32 / H100_F32_FLOPS)
    d32["bound_bwd_ms"] = 1e3 * max(bwd_bytes / H100_BYTES,
                                    10 * 128 * n32 / H100_F32_FLOPS)
    d32["launches_per_step"] = d_per_step
    d32["err_vs_plain"] = err_d32
    print(f"time {card} kernel D [128,128,128,64] f32 (phase 1, VGGish "
          f"compression; {d_per_step} launches per step): forward "
          f"{d32['fwd_ms']:.3f} ms, plain {d32['plain_fwd_ms']:.3f}, bound "
          f"{d32['bound_fwd_ms']:.4f} ms (bytes: {fwd_bytes / 1e9:.3f} GB at "
          f"3.35 TB/s); backward to the target {d32['bwd_ms']:.3f} ms, "
          f"plain {d32['plain_bwd_ms']:.3f}, bound {d32['bound_bwd_ms']:.4f} "
          f"ms (bytes: {bwd_bytes / 1e9:.3f} GB)")
    times["kernel_d_f32"] = d32
    del p32, t32
    mem = torch.cuda.max_memory_allocated() / 2**20
    print(f"memory {card} max_memory_allocated {mem:.1f} MiB")
    times.update({"kernel_b_ms": kb_ms, "plain_b_ms": pb_ms,
                  "bound_b_ms": bound_b_ms, "kernel_b_out_of_place_ms":
                  kb_out_ms, "max_memory_mib": mem})
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
        {"name": "fused_ddim_update", "route": "cuda",
         "source": "music_style_transfer_ldm_tpu_torch/csrc/ddim_update.cu",
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
        {"name": "normalized_mse", "route": "cuda",
         "source": "music_style_transfer_ldm_tpu_torch/csrc/normalized_mse.cu",
         "replaces": "music_style_transfer_ldm_tpu/ops/pallas/"
                     "normalized_mse.py:92",
         "launches": (train_launches["normalized_mse_forward"]
                      + train_launches["normalized_mse_backward"]),
         "max_abs_err": err_d["abs"], "ms": kd_ms, "plain_ms": pd_ms,
         "bound_ms": bound_d_ms, "bound_by": bound_d_by, "library_ms": None,
         "phase1_f32": d32},
        {"name": "fused_vggish_distance", "route": "cuda",
         "source": "music_style_transfer_ldm_tpu_torch/csrc/fused_trunk.cu",
         "replaces": "music_style_transfer_ldm_tpu/ops/pallas/"
                     "fused_trunk.py:549",
         "launches": train_launches["fused_trunk"],
         "max_abs_err": err_e["value_abs"],
         "ms": times["kernel_e_ms"]["value_b128"],
         "plain_ms": times["plain_e_ms"]["value_b128"],
         "bound_ms": times["bound_e_ms"]["value_b128"],
         "bound_by": "operations", "library_ms": e_library_ms},
    ]
    by_path = {"normalized_mse": ("normalized_mse_forward",
                                  "normalized_mse_backward"),
               "fused_vggish_distance": ("fused_trunk",)}
    for k in kernels:
        names = by_path.get(k["name"], (k["name"],))
        k["launches_by_path"] = {p: sum(n[x] for x in names)
                                 for p, n in results["launches"].items()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**results, "kernels": kernels}, f, indent=1)
    print("library call: none for A-D (no single PyTorch call computes "
          "them); E's is the sum of one cuDNN bf16 channels_last F.conv2d "
          "per trunk conv at B=128 (2B images), "
          f"{e_library_ms:.3f} ms (the port never calls it); kernel times "
          "in the line below: A and C at B=1, B in place at [8,16,16,32] "
          "with bf16 eps (the sampler's entry), D's "
          "forward at layer 1 bf16 B=128, E's value at bf16 B=128; the "
          "other shapes beside them above")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
