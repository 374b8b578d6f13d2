#!/usr/bin/env python3
"""The PyTorch port's check on one NVIDIA H100.

    python3 chip_smoke.py [--out results.json]

Phases, in order; any failure exits non-zero:
  1. device: a CUDA card is required (there is no CPU path);
  2. build: nvcc compiles the fused-trajectory kernel (A), the DDIM
     update (B), the mel front-end kernel (C), the normalized-MSE layer
     (D) and the VGGish trunk (E), all CUDA C++ for sm_90a, one nvcc per
     source, and the host compiler the spec-pack reader, all in parallel;
  3. every kernel against its plain PyTorch version at the main paths'
     shapes, with the tolerances stated below (A at B = 1, 3, 4, 8; B
     at B = 4, 8, 64 with f32 and bf16 eps, out of place and in place with its pred_x0 output; C on four
     spectrum sets, then on a filterbank with no zero entry and on one
     with all-zero rows); kernel D's six-column
     statistics and its run-to-run determinism; kernel E's five bf16
     convs one by one at B=128 (forward and input gradient, integer and
     random operands, against exact f32 tap sums), timed beside their
     bound and a cuDNN bf16 call;
  4. the image-level path: SDEdit transfer served by the InferenceEngine
     at full width (random weights from seed 0, bf16), on the fused route
     (every bucket of the ladder) and, through a second engine, the scan
     route, with the kernels' launch counts read around it; the same
     seeded request twice on each route, and generation twice, bit-equal
     in image and audio (cuDNN's deterministic algorithms);
  5. the WAV path, as a user runs it: a port checkpoint of the same
     weights, ``cli transfer`` (a 9 s 44.1 kHz stereo WAV -> PNG + WAV,
     fused sampler, 100 steps, overlap 0.5, content phases; run twice,
     bit-equal WAVs), ``cli generate``, and the HTTP server on an ephemeral localhost port
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
  6d. the data path at the reference's scale: seeded WAVs, 4 instruments
     x one 30-minute file (three 22.05 kHz mono, one 44.1 kHz 16-bit
     stereo, silence at both ends), through ``cli build-dataset`` (kernel
     C at B = 64 and each file's remainder: its launches counted against
     ceil(chunks / 64) per file, its PNGs against the host arithmetic,
     both batch sizes held against the plain version on real chunks and
     B = 64 timed beside its bound); ``datasets.packed --pack`` (the
     native reader required, bit-equal to the numpy one on 1,024 seeded
     indices); ``cli generate-pairings`` (15,000); ``BatchLoader`` over
     the PNGs, ``PackedBatchLoader(uint8)`` and ``DevicePairLoader`` over
     the card-resident corpus: their first 20 batches of B=128 identical
     on the card after ``as_unit_images``, each timed alone, then 20 LDM
     steps (B=128, bf16, defaults) fed by each (host clock, device time,
     idle share, peak memory), with the launch counts read around them;
  6e. the data-parallel path (``parallel/``): (i) two ranks of this
     script on the one card over gloo with CUDA tensors: f32 LDM, AE and
     distill steps (TF32 off) on a global batch of 8 with 7 real rows,
     each against the one-process step on the 7 rows (losses,
     gradients, BatchNorm statistics; the AE with LPIPS and KL, each
     alone and neither), garbage in the pad row, kernel D and E
     launches per rank; (ii) 20 bf16 LDM steps at the defaults,
     global B=128 as 2 x 64, fed by ``DevicePairLoader(mesh=)`` (host
     clock, kernel time, idle share, bytes all-reduced, peak memory per
     rank); (iii) ``python -m torch.distributed.run --nproc-per-node 1
     -m ...cli train --model ldm`` on nccl (2 steps at B=128), and the
     data-parallel machinery at world size 1 (one rank started with
     torchrun's environment, on nccl) against the plain trainer;
     (iv) the engine over two replicas on the one card against the
     single-replica scan engine (f32, cuDNN deterministic; images, and
     audio at the replicas' own batch), with kernel B and C launches and
     the latency of each bucket;
  6f. the model axis (``parallel/``, tensor and sequence parallelism):
     (i) ranks of this script on the one card over gloo at (1, 2) (6e
     (i)'s two ranks, on their process group after 6e's steps) and
     (2, 2): f32 tensor-parallel LDM, AE and distill steps on 6e (i)'s 7
     real rows (a pad row at two data indices) against 6e's one-process
     steps and, for the LDM and AE, against one process with the ranks'
     ReLU gates and max-pool choices pinned (every moved route within
     rounding of a tie), a sequence-parallel LDM step on 64 x 256 against
     one process, and at (1, 2) the 128 x 1024 forward on width blocks
     (losses, gradients gathered whole, BatchNorm statistics; kernels D
     and E launched in every rank's tensor- and sequence-parallel
     steps); (ii) 20 bf16 LDM steps at the defaults, B=64, under (1, 2)
     tensor and (1, 2) sequence parallelism beside one process (host
     clock, kernel time, idle share, bytes per step by axis, peak memory
     per rank; the model peers' replicated tensors hash equal after
     them), and the 128 x 1024 step's peak memory per rank beside one
     process;
  6g. the JAX package's loss API: ``VGGishFeatureLoss`` (f32, 128x128,
     seeded integer-valued and random trunks, B = 8 and 128) on each of
     its three routes (value only: kernel E value-only; a gradient to
     ``predicted``: E with grad; a gradient to ``target``: kernel D per
     layer) against the same call with ``impl="plain"`` at phase 3's
     bars (the integer trunk's calls with cuDNN off, whose f32
     algorithms at B = 128 are not exact on integers), every call's E
     and D launches asserted, each route timed at
     B = 128 beside E's f32 bound; ``perceptual_loss`` (the extractor as
     given, bit for bit; the cached default LPIPS on the card against
     the CPU); ``gram_matrix``, ``mel_filterbank`` and
     ``SinusoidalPositionEmbeddings`` card against CPU; the card's peak
     figures from ``utils/chips.py``, which every bound here reads;
  7. times with CUDA events (host clock for the CLI, HTTP and training
     steps), each printed with the card's name and power limit: the
     channels-last GroupNorm kernel at Riffusion's shapes (bf16, with and
     without SiLU) against its plain version in f32 and run to run,
     beside its bytes bound, its plain version and nn.GroupNorm + F.silu,
     and one full-size Riffusion dispatch with every norm through it
     (alone: ``python3 chip_smoke.py --group-norm-only``); kernel A
     at B = 1, 2, 4, 8 beside the scan route and the bound, with its grid,
     shared memory per block and launch plan; kernels B and C back to
     back, and also their device time per launch (CUDA events over
     launches queued behind a sleep kernel) and host time per call
     (1,000 calls, no sync); the engines' requests at B = 1 and 8 on
     cuDNN's deterministic algorithms and on its default choice, in
     turns; a profile of one training step; the AE step at B=128 f32 with LPIPS and with VGGish
     compression (host clock, device time, idle share, peak memory); and
     kernel D in f32 at layer 1, B=128, held against its plain version
     (m, statistics, target gradient) and timed beside its bytes bound;
     kernel A on the students' 6-, 3- and 1-step grids at B = 1 and 8
     beside its 49-step time and the bound of each; the 3-step student's
     ``cli transfer`` beside its teacher's 99-step one on the same clip;
     the evaluation block's wall time; kernel E f32 value-only at the
     evaluation batch beside its bound; and the distill step at B=128
     bf16, factor 2, unguided and guided (host clock, device time, idle
     share, peak memory);
  8. the benchmark, as a user runs it: ``python -m
     music_style_transfer_ldm_tpu_torch.cli bench`` in a process of its
     own with a time limit; its last JSON line holds every key of the
     JAX package's headline set, each finite and positive, both MFUs in
     (0, 1], ``value`` x 49 within 10 % of phase 7's kernel A B=1
     trajectory, and its launch line shows kernels A, B, D and E
     launched (``launches_by_path["bench"]``);
  9. the tools, as a user runs them, each a process of its own, all at
     once on the shared card: the serving load curve on the scan and the
     fused route (25, 50, 100 clips/s, 3 s each; every request answered),
     the B=64 roofline (``--chain 4``; every stage at most 1.05 of its
     bound, kernel A's stage 8 launches at B=8), the three evaluations
     on phase 6's checkpoint, phase 6c's 3-step student and phase 6d's
     pack (4 pairs), the full-scale recipe at 30 s a voice and one
     epoch a phase on the card-resident corpus, and the end-to-end demo;
     their launch lines summed (``launches_by_path["tools"]``, A-E each
     launched).
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
import math
import os
import shutil
import struct
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
# Phase 6d's WAVs: 1,798.5 s of content (599.5 chunks of 3 s, so a trim
# within a frame of the content leaves 600) inside 0.75 s of silence at
# both ends: 30 minutes a file, the reference's cap.
DATA_CONTENT_S = 1798.5
DATA_SILENCE_S = 0.75

# The card's dense bf16 tensor-core rate and HBM rate: read in ``main``
# from utils/chips.py by the card's name (an unknown card fails the run).
# The f32 rate outside the tensor cores (NVIDIA's H100 SXM datasheet) has
# no column there.
H100_BF16_FLOPS = H100_BYTES = None
H100_F32_FLOPS = 67e12


# Phase 8 runs ``cli bench`` in a process of its own for at most this
# long (the bench is sized to take about 2 minutes on the H100).
BENCH_TIMEOUT_S = 400


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class Laps:
    """Wall seconds of each phase of ``main``, in its order."""

    def __init__(self):
        self.seconds: dict = {}
        self._name, self._t = None, time.perf_counter()

    def start(self, name) -> None:
        now = time.perf_counter()
        if self._name is not None:
            self.seconds[self._name] = round(now - self._t, 2)
        self._name, self._t = name, now


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


def device_us(fn, reps=50):
    """Mean card microseconds per call of fn: reps calls queued behind a
    sleep kernel long enough that the host has issued them all before the
    card reaches the first, timed by CUDA events around them.  The host's
    issue time is hidden; the card's gap between launches is counted.
    (torch.profiler's short windows missed 1 to 50 of 50 launches once
    other profiles had run in the process.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        for _ in range(reps):
            fn()
        marks[2].record()
        issue_ms = 1e3 * (time.perf_counter() - t0)
        marks[2].synchronize()
        # the card left the sleep after the host had issued the last call
        if marks[0].elapsed_time(marks[1]) > issue_ms:
            return 1e3 * marks[1].elapsed_time(marks[2]) / reps
        cycles *= 4
    fail(f"a sleep of {cycles // 4} cycles did not cover the host's issue "
         f"of {reps} calls")


# The channels-last GroupNorm kernel (ops/group_norm.py) at Riffusion's
# shapes, bf16: the UNet's [8, 320, 64, 64] and [8, 960, 64, 64] (8
# guided rows at 512x512) and the VAE's [4, 128, 512, 512].
GROUP_NORM_SHAPES = ((8, 320, 64, 64), (8, 960, 64, 64), (4, 128, 512, 512))
# bf16 kernel vs the f32 plain version on the same input: one rounding
# to bf16 (2^-9 of the value) with room, plus f32 sums and __expf.
TOL_GN_BF16_REL, TOL_GN_BF16_ABS = 2.0 ** -8, 1e-4


def group_norm_times(card: str, hbm_bytes: float) -> dict:
    """The GroupNorm kernel at GROUP_NORM_SHAPES in bf16, with and without
    SiLU, held against its plain version in f32 and timed (CUDA events,
    back to back, so a tensor under the 50 MB L2 may stay in it) beside
    its bytes bound (x read once, y written once), its plain version
    (which returns channels-last) and nn.GroupNorm + F.silu on the same
    channels-last input (PyTorch's copy to NCHW included; its NCHW output
    not copied back).  Returns {shape: {silu: {...}}}."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from music_style_transfer_ldm_tpu_torch.ops import group_norm as gn

    built = gn.build_group_norm()
    print(f"build group_norm_nhwc.cu: {built['seconds']:.1f} s")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    out: dict = {}
    for shape in GROUP_NORM_SHAPES:
        N, C, H, W = shape
        x = torch.randn(shape, device=dev, generator=g).mul_(2.0).add_(
            0.5).bfloat16().contiguous(memory_format=torch.channels_last)
        mod = nn.GroupNorm(32, C, 1e-5).to(dev, torch.bfloat16)
        with torch.no_grad():
            mod.weight.copy_(1 + 0.1 * torch.randn(C, device=dev,
                                                   generator=g))
            mod.bias.copy_(0.1 * torch.randn(C, device=dev, generator=g))
        w, b = mod.weight.detach(), mod.bias.detach()
        bound_ms = 1e3 * 2 * x.numel() * x.element_size() / hbm_bytes
        key = "x".join(map(str, shape))
        out[key] = {}
        for silu in (False, True):
            y = gn.group_norm_nhwc(x, w, b, 32, 1e-5, silu=silu)
            want = gn.group_norm_nhwc_reference(
                x.float(), w.float(), b.float(), 32, 1e-5, silu=silu)
            err = (y.float() - want).abs()
            over = (err - TOL_GN_BF16_REL * want.abs()).max().item()
            check(y.is_contiguous(memory_format=torch.channels_last)
                  and y.dtype == torch.bfloat16, "group norm layout")
            check(over <= TOL_GN_BF16_ABS,
                  f"group norm {key} silu={silu} vs plain f32: "
                  f"{over:.3g} over {TOL_GN_BF16_REL:.3g} of the value")
            again = gn.group_norm_nhwc(x, w, b, 32, 1e-5, silu=silu)
            check(torch.equal(again, y), f"group norm {key} run to run")
            reps = 20 if x.numel() > 1e8 else 100
            act = F.silu if silu else (lambda t: t)
            row = {
                "ms": cuda_ms(lambda: gn.group_norm_nhwc(
                    x, w, b, 32, 1e-5, silu=silu), reps),
                "bound_ms": bound_ms,
                "plain_ms": cuda_ms(lambda: gn.group_norm_nhwc_reference(
                    x, w, b, 32, 1e-5, silu=silu), reps),
                "library_ms": cuda_ms(lambda: act(mod(x)), reps),
                "host_us": host_us(lambda: gn.group_norm_nhwc(
                    x, w, b, 32, 1e-5, silu=silu), 200),
                "library_host_us": host_us(lambda: act(mod(x)), 200),
                "max_err": err.max().item()}
            out[key][str(silu)] = row
            print(f"time {card} group norm {key} bf16 silu={silu}: kernel "
                  f"{row['ms']:.4f} ms, bound {bound_ms:.4f} "
                  f"({100 * bound_ms / row['ms']:.1f} %), plain "
                  f"{row['plain_ms']:.4f}, nn.GroupNorm+silu "
                  f"{row['library_ms']:.4f}; host {row['host_us']:.1f} us "
                  f"a call (nn.GroupNorm+silu {row['library_host_us']:.1f}); "
                  f"max err vs plain f32 {row['max_err']:.3g}")
        del x
    return out


def group_norm_dispatch(card: str) -> dict:
    """One served Riffusion dispatch of 4 clips at full size (seeded
    weights, bf16, 512x512, 37 guided UNet calls at 8 rows, the VAE's
    encode and decode) under the program tracer and torch.profiler: every
    norm through the kernel (``group_norm.calls`` = 37 x 61 + 22 + 30, as
    many kernel pairs launched), no PyTorch GroupNorm kernel on the card,
    and the dispatch's heaviest device kernels."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from music_style_transfer_ldm_tpu_torch.models.clip_text import (
        prompt_ids,
    )
    from music_style_transfer_ldm_tpu_torch.models.riffusion import (
        build_riffusion, riffusion_transfer,
    )
    from music_style_transfer_ldm_tpu_torch.ops import group_norm as gn
    from music_style_transfer_ldm_tpu_torch.utils import profiling

    dev, clips = torch.device("cuda"), 4
    model = build_riffusion(device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    content = torch.rand(clips, 512, 512, 1, device=dev, generator=g)
    ids = torch.as_tensor(np.stack([
        prompt_ids(list(range(1, 6 + i)), model.config.text)
        for i in range(clips)]), device=dev)

    def dispatch():
        return riffusion_transfer(model, content, ids,
                                  seeds=list(range(clips)))
    dispatch()
    torch.cuda.synchronize()
    launches = gn.group_norm_nhwc.launches
    tracer = profiling.enable()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dispatch()
            torch.cuda.synchronize()
    finally:
        profiling.disable()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    calls = tracer.counters.get("group_norm.calls", 0)
    pairs = gn.group_norm_nhwc.launches - launches
    per_name: dict = {}
    for e in prof.key_averages():
        if e.device_type.name == "CUDA" and e.device_time_total > 0:
            ms, n = per_name.get(e.key, (0.0, 0))
            per_name[e.key] = (ms + e.device_time_total / 1e3, n + e.count)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    top += [kv for kv in per_name.items() if "gn_" in kv[0] and kv not in top]
    print(f"riffusion dispatch {card} ({clips} clips, profiled, wall "
          f"{wall_ms:.1f} ms): group_norm.calls {calls}, kernel pairs "
          f"{pairs}; device ms by kernel:")
    for name, (ms, n) in top:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:110]}")
    moments = [n for n in per_name if "RowwiseMoments" in n
               or "GroupNorm" in n]
    check(calls == 37 * 61 + 22 + 30,
          f"group_norm.calls {calls} in one dispatch")
    check(pairs == calls, f"{pairs} kernel pairs for {calls} norms")
    check(not moments, f"PyTorch's GroupNorm kernels ran: {moments}")
    del model
    torch.cuda.empty_cache()
    return {"group_norm_calls": calls, "kernel_pairs": pairs,
            "profiled_wall_ms": wall_ms,
            "device_ms_top": [[name, ms, n] for name, (ms, n) in top]}


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
    """[(device us, kernel name, launches)] of the card's kernels in one
    call of fn, largest first, from the port's ``utils/profiling.py
    trace`` of that call (which also writes it to
    ``log_dir/trace.json``)."""
    from music_style_transfer_ldm_tpu_torch.utils.profiling import trace
    with trace(log_dir) as prof:
        fn()
    out = []
    for evt in prof.key_averages():
        if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
            continue      # host-side ops; their kernels are listed apart
        if getattr(evt, "is_user_annotation", False):
            # a record_function range on the card's timeline (e.g.
            # "Optimizer.step#Adam.step"): its span covers its kernels,
            # counted apart, and the idle gaps between them
            continue
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            out.append((dev_us, evt.key, evt.count))
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


# ---- phase 6e's ranks: this script started again, one process per rank ----
TOL_DP_LOSS = 1e-5       # relative: the ranks' global losses vs one process
TOL_DP_GRAD = 1e-4       # of each parameter's max |grad| (grad_err_of_max)
TOL_DP_STATS = 1e-5      # relative to the largest running statistic
TOL_DP_GARBAGE = 1e-6    # relative: garbage in the pad rows, per metric
TOL_DP_SERVE = 1e-4      # f32 images and audio: the meshed engine vs one
                         # replica (the audio at the replicas' batch)
# The AE's encoder gradients with the KL term on, of max (per parameter,
# as grad_err_of_max): the KL term's z / (z^2 + 1e-8) turns the forward's
# rounding into 1.15e-2 here, LPIPS alone into 4.1e-6 (PERF.md section
# 2). Every other AE gradient is held at TOL_DP_GRAD.
TOL_AE_KL_ENCODER = 3e-2


def dp_counted():
    """The kernel wrappers whose launches the script counts."""
    from music_style_transfer_ldm_tpu_torch.ops import fused_mel_image as fm
    from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
    from music_style_transfer_ldm_tpu_torch.ops import fused_trunk as ft
    from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm
    from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
        fused_ddim_update,
    )
    return (fs.fused_ddim_sample, fused_ddim_update, fm.fused_mel_unit_image,
            nm.normalized_mse_forward, nm.normalized_mse_backward,
            ft.fused_trunk)


def dp_f32_config():
    from music_style_transfer_ldm_tpu_torch.config import default_config
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train, compute_dtype="float32")
    return cfg


def dp_ae_cases(cfg) -> tuple:
    """The AE steps of 6e (i): the defaults (LPIPS and the KL term), each
    of the two terms alone, and neither, to show which term carries the
    defaults' gradient spread between 2 ranks and one process."""
    def with_kl(kl):
        c = dataclasses.replace(cfg)
        c.train = dataclasses.replace(cfg.train, kl_weight=kl)
        return c
    return (("ae", cfg, True), ("ae_no_kl", with_kl(0.0), True),
            ("ae_no_lpips", cfg, False), ("ae_plain", with_kl(0.0), False))


AE_CASES = ("ae", "ae_no_kl", "ae_no_lpips", "ae_plain")


def dp_grad_of_max_by_part(got: dict, want: dict) -> dict:
    """grad_err_of_max per component (the first name part: encoder,
    decoder), the parameters skipped by the whole model's largest
    gradient as there."""
    top = max(v.abs().max().item() for v in want.values())
    out: dict = {}
    for k, v in want.items():
        scale = v.abs().max().item()
        if scale < 1e-5 * top:
            continue
        part = k.split(".")[0]
        out[part] = max(out.get(part, 0.0),
                        (got[k] - v).abs().max().item() / scale)
    return out


def dp_grads(module) -> dict:
    return {k: p.grad.detach().cpu() for k, p in module.named_parameters()
            if p.grad is not None}


def dp_stats(module) -> dict:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()
            if "running" in k}


def dp_steps(spec: dict, res: dict) -> None:
    """6e (i), one rank of two on the one card: f32 LDM steps (clean and
    with garbage in the pad row), an AE step and a distill step on this
    rank's rows of the global batch of 8 (7 real), draws injected."""
    import torch
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.parallel import (
        batch_validity_weights, make_mesh, shard_batch,
    )
    from music_style_transfer_ldm_tpu_torch.training import (
        AETrainer, LDMTrainer, ProgressiveDistiller,
    )
    torch.backends.cudnn.deterministic = True
    cfg = dp_f32_config()
    mesh = make_mesh()
    w = batch_validity_weights(spec["n_real"], mesh.data_size, mesh)

    def rows(*keys):
        return shard_batch(tuple(torch.as_tensor(spec[k]) for k in keys),
                           mesh)
    for tag in ("clean", "garbage"):
        tr = LDMTrainer(cfg)
        st = tr.init_state(0)
        st.model.load_state_dict(spec["ldm"])
        c, s, t, noise = rows(f"content_{tag}", f"style_{tag}", "t", "noise")
        st, m = tr._step(st, c, s, t=t.long(), noise=noise, weights=w)
        res[f"ldm_{tag}"] = {"metrics": {k: v.item() for k, v in m.items()},
                             "grads": dp_grads(st.model),
                             "stats": dp_stats(st.model.decoder)}
    (x,) = rows("content_clean")
    for case, ae_cfg, perceptual in dp_ae_cases(cfg):
        ae = AETrainer(ae_cfg, perceptual=perceptual)
        st = ae.init_state(0)
        st.model.load_state_dict(spec["ae"])
        st, loss = ae._step(st, x, weights=w)
        res[case] = {"loss": loss.item(), "grads": dp_grads(st.model),
                     "stats": dp_stats(st.model)}
    dist = ProgressiveDistiller(cfg, t_max=100)
    student = build_ldm(cfg, dtype=torch.float32, device=mesh.device, seed=0)
    student.load_state_dict(spec["ldm"])
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, 4, 2, 1e-4)
    c, s, seg, dn = rows("content_clean", "style_clean", "segment",
                         "d_noise")
    dist.draws = lambda *a: (seg.long(), dn)
    loss = dist.step(student, stage, c, s, 0, 0, weights=w)
    res["distill"] = {"loss": loss.item(), "grads": dp_grads(student.unet)}


def dp_loader(spec: dict, res: dict) -> None:
    """6e (ii), one rank of two on the one card: 20 bf16 LDM steps at the
    defaults, global B=128 split 2 x 64, fed by DevicePairLoader over the
    corpus on the card; host clock, kernel time, idle share, bytes
    all-reduced, peak memory, launches."""
    import torch
    from music_style_transfer_ldm_tpu_torch.datasets import (
        DevicePairLoader, DeviceResidentPairs,
    )
    from music_style_transfer_ldm_tpu_torch.parallel import make_mesh
    from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
        COUNTS,
    )
    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.training import LDMTrainer
    mesh = make_mesh()
    resident = DeviceResidentPairs(spec["spk"], spec["pairs"], mesh=mesh)
    order = spec["order"]

    def loader(ids):
        return DevicePairLoader(resident, 128, indices=ids, shuffle=False)
    tr = LDMTrainer(default_config())
    st, _ = tr.train_epoch(tr.init_state(0), loader(order[:256]))
    counted = dp_counted()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    before = dict(COUNTS)
    t0 = time.perf_counter()
    st, metrics = tr.train_epoch(st, loader(order))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 20
    res["launches"] = {fn.__name__: fn.launches for fn in counted}
    ddp_bytes = sum(p.numel() * p.element_size()
                    for p in st.model.parameters() if p.requires_grad)
    box = [st]

    def three():
        box[0], _ = tr.train_epoch(box[0], loader(order[:384]))
    kernels = profiled_kernels(three, Path(spec["profile"])
                               / f"rank{mesh.index}")
    device_ms = sum(us for us, *_ in kernels) / 1e3 / 3
    res["loader"] = {
        "ms_per_step": ms, "metrics": metrics,
        "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
        "device_ms_per_step": device_ms,
        "idle_share": (1.0 - device_ms / ms) if device_ms > 0 else None,
        "allreduce_bytes_per_step": ddp_bytes + (
            COUNTS["all_reduce_bytes"] - before["all_reduce_bytes"]) / 20,
        "ddp_gradient_bytes": ddp_bytes,
        "other_allreduce_calls_per_step": (
            COUNTS["all_reduce_calls"] - before["all_reduce_calls"]) / 20,
        "top_kernels_ms": [(k[:60], us / 1e3 / 3)
                           for us, k, _ in kernels[:5]]}


def dp_world_size_1(spec: dict, res: dict) -> None:
    """6e (iii), one rank in the environment torchrun gives it, on nccl:
    the data-parallel machinery at world size 1 (DistributedDataParallel,
    BatchNorm's all_reduce) against the plain trainer, bf16 B=128."""
    import torch
    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.parallel import make_mesh
    from music_style_transfer_ldm_tpu_torch.training import LDMTrainer
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    c = torch.rand(128, 128, 128, 1, device=dev, generator=g)
    s = torch.rand(128, 128, 128, 1, device=dev, generator=g)
    trainers = {"dp": LDMTrainer(default_config()),
                "plain": LDMTrainer(default_config(),
                                    mesh=make_mesh(devices=[dev]))}
    check(trainers["dp"].mesh.distributed
          and not trainers["plain"].mesh.distributed, "6e (iii) meshes")
    states = {k: tr.init_state(0) for k, tr in trainers.items()}
    out = {k: [] for k in trainers}
    metrics = {}
    for name in ("plain", "dp", "dp", "plain"):
        tr = trainers[name]
        for _ in range(2):                                  # warm-up
            states[name], _ = tr._step(states[name], c, s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            states[name], m = tr._step(states[name], c, s)
        torch.cuda.synchronize()
        out[name].append(1e3 * (time.perf_counter() - t0) / 10)
        metrics[name] = {k: v.item() for k, v in m.items()}
    res["ws1"] = {"ms_per_step": out, "metrics": metrics,
                  "backend": torch.distributed.get_backend()}


# ---- phase 6f's ranks: the model axis (tensor, sequence parallelism) ----
# A split layer computes its block of channels with other cuDNN calls
# than one process, so its f32 rounding differs, and where a ReLU's input
# lies within that rounding of 0, or two values of a max-pool window lie
# within it of each other, the route flips: a step in every gradient
# behind it (the AE with neither term at (1, 2): 2.6e-3 of max against
# one process, identical in every run of this script).  So each
# tensor-parallel step's model index 0 records its routes (``Routing``),
# one process runs the same step again with them pinned, and the ranks'
# gradients are held to that run at 6e's bars; every route that differs
# from one process's own must lie within TOL_FLIP_OF_MAX of its input's
# largest |value| of a tie (a flip further out would be a fault, not
# rounding).  Data and sequence parallelism run their convs at one
# process's channel counts, and are held without pinning.
TOL_FLIP_OF_MAX = 1e-4
# The 128 x 1024 forward (the JAX package's tests/test_parallel.py): rtol
# 1e-4, atol 1e-5 on the reconstruction and 2e-5 on the noise prediction.
TOL_WIDE_RTOL, TOL_WIDE_ATOL_REC, TOL_WIDE_ATOL_EPS = 1e-4, 1e-5, 2e-5
TP_CASES = ("tp_ldm", "tp_ae", "tp_ae_plain")   # the steps run pinned


class Routing:
    """``torch.relu`` and ``F.max_pool2d`` while the block runs (every ReLU
    and max-pool of the models and of LPIPS calls them), either recording
    each call's route (kind, input shape, array: a ReLU's gate, input >
    0, as packed bits; a max-pool's choice in each window, its flat
    index in the plane), or, given ``pinned`` routes recorded so, taking
    those instead (the gradient then follows them too).  Pinned, it
    counts the routes that differ from this run's own and how far the
    furthest lies from a tie, relative to its input's largest |value|:
    a flipped gate's |input|, a moved max-pool's gap between the two
    values."""

    def __init__(self, pinned=None):
        self.routes, self.pinned = [], pinned
        self.calls, self.flips, self.flip_of_max = 0, 0, 0.0

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        self._relu, torch.relu = torch.relu, self._gate
        self._pool, F.max_pool2d = F.max_pool2d, self._max_pool
        return self

    def __exit__(self, *exc):
        import torch
        import torch.nn.functional as F
        torch.relu, F.max_pool2d = self._relu, self._pool

    def _next(self, kind, x):
        check(self.calls < len(self.pinned), f"6f: more {kind} calls than "
              "the ranks recorded")
        got, shape, route = self.pinned[self.calls]
        self.calls += 1
        check((got, shape) == (kind, tuple(x.shape)), f"6f: call "
              f"{self.calls} is a {kind} of {tuple(x.shape)}, the ranks' a "
              f"{got} of {shape}")
        return route

    def _moved(self, n: int, gap) -> None:
        if n:
            self.flips += n
            self.flip_of_max = max(self.flip_of_max, gap().item())

    def _gate(self, x):
        import numpy as np
        import torch
        own = x > 0
        if self.pinned is None:
            self.routes.append(("relu", tuple(x.shape),
                                np.packbits(own.cpu().numpy().ravel())))
            return self._relu(x)
        bits = self._next("relu", x)
        gate = torch.from_numpy(np.unpackbits(
            bits, count=own.numel()).astype(bool)).reshape(
                own.shape).to(x.device)
        flipped = own != gate
        self._moved(int(flipped.sum()),
                    lambda: x[flipped].abs().max() / x.abs().max())
        return x * gate.to(x.dtype)

    def _max_pool(self, x, *args, **kwargs):
        import torch
        y, own = self._pool(x, *args, return_indices=True, **kwargs)
        if self.pinned is None:
            self.routes.append(("max_pool", tuple(x.shape),
                                own.to(torch.int32).cpu().numpy()))
            return y
        idx = torch.from_numpy(self._next("max_pool", x)).to(
            x.device, torch.int64)
        pinned = x.flatten(2).gather(2, idx.flatten(2)).view_as(y)
        moved = own != idx
        self._moved(int(moved.sum()),
                    lambda: (y - pinned).abs().max() / x.abs().max())
        return pinned


def merge_routes(per_index: list, local_rows: int, rows: int) -> list:
    """One process's routes from each data index's (its ranks' inputs are
    [k x local_rows, ...] for k blocks of its rows, as a batch of content
    and style concatenated): each call's blocks joined row-wise in data
    index order, the pad rows dropped."""
    import numpy as np
    out = []
    for calls in zip(*per_index):
        kind, shape, _ = calls[0]
        check(shape[0] % local_rows == 0, f"6f: a {kind} input of shape "
              f"{shape} is not in blocks of {local_rows} rows")
        k = shape[0] // local_rows
        blocks = []
        for _, _, route in calls:
            full = (np.unpackbits(route, count=int(np.prod(shape))).reshape(
                shape) if kind == "relu" else route)
            blocks.append(full.reshape((k, local_rows) + full.shape[1:]))
        joined = np.concatenate(blocks, 1)[:, :rows]
        joined = joined.reshape((k * rows,) + joined.shape[2:])
        out.append((kind, (k * rows,) + shape[1:],
                    np.packbits(joined.ravel()) if kind == "relu"
                    else joined))
    return out


def mp_config(shape, sequence_parallel=False, f32=True):
    from music_style_transfer_ldm_tpu_torch.config import default_config
    cfg = dp_f32_config() if f32 else default_config()
    cfg.mesh = dataclasses.replace(cfg.mesh, mesh_shape=tuple(shape),
                                   sequence_parallel=sequence_parallel)
    return cfg


def mp_steps(spec: dict, res: dict) -> None:
    """6f (i), one rank of an (n, m) mesh on the one card: f32
    tensor-parallel LDM, AE and distill steps on this data index's rows of
    phase 6e's global batch of 7 (padded to 8 at two data indices; model
    index 0 records the LDM's and the AE's routes, ``Routing``), a
    sequence-parallel LDM step on 64 x 256, and at (1, 2) the 128 x 1024
    forward on width blocks; draws injected, gradients and statistics
    gathered whole, launches of kernels D and E counted per part.  At
    (1, 2) the ranks then run 6f (ii)'s cost (``mp_cost``)."""
    import torch
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.parallel import make_mesh
    from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
        model_axis,
    )
    from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
        gather_tensors, gathered_state_dict, local_blocks, rank_batch,
        shard_batch, shard_params, split_dims,
    )
    from music_style_transfer_ldm_tpu_torch.training import (
        AETrainer, LDMTrainer, ProgressiveDistiller,
    )
    torch.backends.cudnn.deterministic = True
    shape = tuple(spec["shape"])
    mesh = make_mesh(shape)
    counted = dp_counted()
    res["routes"] = {}

    def whole_grads(module):
        grads = {k: p.grad for k, p in module.named_parameters()
                 if p.grad is not None}
        return {k: v.cpu() for k, v in gather_tensors(
            grads, split_dims(module), mesh).items()}

    def whole_stats(module):
        return {k: v.cpu() for k, v in gathered_state_dict(
            module, mesh).items() if "running" in k}

    def launches():
        out = {fn.__name__: fn.launches for fn in counted}
        for fn in counted:
            fn.launches = 0
        return out

    def gated(case, step):
        """``step()``, its routes recorded on model index 0."""
        if mesh.model_index:
            return step()
        with Routing() as g:
            out = step()
        res["routes"][case] = g.routes
        return out

    launches()
    keys = ("content_clean", "style_clean", "t", "noise", "segment",
            "d_noise")
    (c, s, t, noise, seg, dn), w = rank_batch(
        tuple(torch.as_tensor(spec[k][:7]) for k in keys), mesh)
    kw = {} if w is None else {"weights": w}
    tr = LDMTrainer(mp_config(shape), mesh=mesh)
    st = tr.init_state(0)
    st.model.load_state_dict(local_blocks(spec["ldm"], split_dims(st.model),
                                          mesh))
    st, m = gated("tp_ldm", lambda: tr._step(st, c, s, t=t.long(),
                                             noise=noise, **kw))
    res["tp_ldm"] = {"metrics": {k: v.item() for k, v in m.items()},
                     "grads": whole_grads(st.model),
                     "stats": whole_stats(st.model.decoder)}
    for case, ae_cfg, perceptual in dp_ae_cases(mp_config(shape)):
        if f"tp_{case}" not in TP_CASES:
            continue
        ae = AETrainer(ae_cfg, perceptual=perceptual, mesh=mesh)
        st = ae.init_state(0)
        st.model.load_state_dict(local_blocks(spec["ae"],
                                              split_dims(st.model), mesh))
        st, loss = gated(f"tp_{case}", lambda: ae._step(st, c, **kw))
        res[f"tp_{case}"] = {"loss": loss.item(),
                             "grads": whole_grads(st.model),
                             "stats": whole_stats(st.model)}
    dist = ProgressiveDistiller(mp_config(shape), mesh=mesh, t_max=100)
    student = build_ldm(mp_config(shape), dtype=torch.float32,
                        device=mesh.device, seed=0)
    student.load_state_dict(spec["ldm"])
    shard_params(student, mesh)
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, 4, 2, 1e-4)
    dist.draws = lambda *a: (seg.long(), dn)
    loss = dist.step(student, stage, c, s, 0, 0, **kw)
    res["tp_distill"] = {"loss": loss.item(),
                         "grads": whole_grads(student.unet)}
    del tr, ae, dist, student, stage, st
    res["launches_tp"] = launches()

    (c, s), w = rank_batch((torch.as_tensor(spec["sp_content"]),
                            torch.as_tensor(spec["sp_style"])), mesh,
                           sequence_parallel=True)
    (t, noise), _ = rank_batch((torch.as_tensor(spec["sp_t"]),
                                torch.as_tensor(spec["sp_noise"])), mesh)
    kw = {} if w is None else {"weights": w}
    tr = LDMTrainer(mp_config(shape, sequence_parallel=True), mesh=mesh)
    st = tr.init_state(0)
    st.model.load_state_dict(local_blocks(spec["ldm"], split_dims(st.model),
                                          mesh))
    res["sp_block"] = tuple(c.shape)
    st, m = tr._step(st, c, s, t=t.long(), noise=noise, **kw)
    res["sp_ldm"] = {"metrics": {k: v.item() for k, v in m.items()},
                     "grads": whole_grads(st.model),
                     "stats": whole_stats(st.model.decoder)}
    del tr, st
    res["launches_sp"] = launches()
    res["launches"] = {k: res["launches_tp"][k] + res["launches_sp"][k]
                       for k in res["launches_tp"]}
    if shape != (1, 2):
        return
    ldm = build_ldm(mp_config(shape), dtype=torch.float32,
                    device=mesh.device, seed=0)
    x, sty = shard_batch((torch.as_tensor(spec["wide"]),
                          torch.as_tensor(spec["wide_style"])), mesh,
                         sequence_parallel=True)
    with torch.no_grad():
        out = ldm(x, sty, torch.zeros(2, dtype=torch.long,
                                      device=mesh.device),
                  noise=torch.as_tensor(spec["wide_noise"],
                                        device=mesh.device),
                  ax=model_axis(mesh, sequence=True))
    res["wide_forward"] = {k: out[k].cpu()
                           for k in ("noise_pred", "reconstructed")}
    del ldm, out
    torch.backends.cudnn.deterministic = False
    res["cost"] = mp_cost(mesh, spec)


def replicated_digest(module) -> dict:
    """{name: sha256} of every replicated (unsplit) parameter and
    floating buffer of ``module``: model peers that hold the same bits
    give the same digests."""
    import hashlib
    from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
        split_dims,
    )
    split = split_dims(module)
    out = {}
    for k, v in list(module.named_parameters()) + list(
            module.named_buffers()):
        if k not in split and v.is_floating_point():
            out[k] = hashlib.sha256(
                v.detach().cpu().numpy().tobytes()).hexdigest()
    return out


def ldm_cost(tr, c, s, profile_dir: Path, base: int = 0) -> dict:
    """20 timed LDM steps of trainer ``tr`` on (c, s) after a warm-up
    step: host clock, kernel time (3 profiled steps), idle share, the
    collectives' calls and bytes per step, peak memory (above ``base``
    bytes, what the process held before the trainer), launches."""
    import torch
    from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
        COUNTS,
    )
    counted = dp_counted()
    st = tr.init_state(0)
    st, _ = tr._step(st, c, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    before = dict(COUNTS)
    t0 = time.perf_counter()
    for _ in range(20):
        st, m = tr._step(st, c, s)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 20
    out = {"ms_per_step": ms, "metrics": {k: v.item() for k, v in m.items()},
           "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
           "collectives_per_step": {k: (COUNTS[k] - before[k]) / 20
                                    for k in COUNTS},
           "ddp_gradient_bytes": sum(p.numel() * p.element_size()
                                     for p in st.model.parameters()
                                     if p.requires_grad),
           "launches": {fn.__name__: fn.launches for fn in counted}}
    box = [st]

    def three():
        for _ in range(3):
            box[0], _ = tr._step(box[0], c, s)
    kernels = profiled_kernels(three, profile_dir)
    out["device_ms_per_step"] = sum(us for us, *_ in kernels) / 1e3 / 3
    out["idle_share"] = (1.0 - out["device_ms_per_step"] / ms
                         if out["device_ms_per_step"] > 0 else None)
    out["top_kernels_ms"] = [(k[:60], us / 1e3 / 3)
                             for us, k, _ in kernels[:5]]
    out["replicated_digest"] = replicated_digest(box[0].model)
    return out


def wide_cost(tr, c, s, base: int = 0) -> dict:
    """One timed LDM step on 128 x 1024 clips after a warm-up step: host
    clock, peak memory (above ``base`` bytes)."""
    import torch
    st = tr.init_state(0)
    st, _ = tr._step(st, c, s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, m = tr._step(st, c, s)
    torch.cuda.synchronize()
    return {"ms": 1e3 * (time.perf_counter() - t0),
            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
            "metrics": {k: v.item() for k, v in m.items()},
            "block": tuple(c.shape)}


def cost_inputs(dev) -> tuple:
    """6f (ii)'s rows: B=64 content and style at 128 x 128, and B=8 clips
    of 128 x 1024, from a generator seeded 5 on the card."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    return tuple(torch.rand(*shape, device=dev, generator=g) for shape in (
        (64, 128, 128, 1), (64, 128, 128, 1), (8, 128, 1024, 1)))


def mp_cost(mesh, spec: dict) -> dict:
    """6f (ii), one rank of a (1, 2) mesh on the one card: 20 bf16 LDM
    steps at the defaults on B=64 (the data index's rows, alike on both
    ranks), tensor parallel, then sequence parallel (``ldm_cost``); then
    a sequence-parallel bf16 step on B=8 clips of 128 x 1024 and its peak
    memory."""
    from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
        rank_batch,
    )
    from music_style_transfer_ldm_tpu_torch.training import LDMTrainer
    c, s, wide = cost_inputs(mesh.device)
    out = {}
    for mode in ("tp", "sp"):
        sp = mode == "sp"
        (cc, ss), _ = rank_batch((c, s), mesh, sequence_parallel=sp)
        out[mode] = ldm_cost(
            LDMTrainer(mp_config((1, 2), sp, f32=False), mesh=mesh), cc, ss,
            Path(spec["profile"]) / f"{mode}_rank{mesh.index}")
    (cw, sw), _ = rank_batch((wide, wide), mesh, sequence_parallel=True)
    out["wide_step"] = wide_cost(
        LDMTrainer(mp_config((1, 2), True, f32=False), mesh=mesh), cw, sw)
    return out


def mp_one(spec: dict, routes: dict) -> dict:
    """6f's one process, run in this (the main) process after the ranks:
    the f32 steps that (i) holds the ranks to beyond 6e (i)'s (the LDM
    and AE steps again with each tensor-parallel mesh's ReLU gates and
    max-pool choices pinned, ``Routing``; the LDM on 64 x 256; the
    128 x 1024 forward; cuDNN deterministic, draws injected), then (ii)'s
    bf16 cost on the same rows as the ranks, its peak memory counted
    above what the process held before (the earlier phases' tensors)."""
    import gc

    import numpy as np
    import torch
    from music_style_transfer_ldm_tpu_torch.config import default_config
    from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
    from music_style_transfer_ldm_tpu_torch.training import (
        AETrainer, LDMTrainer,
    )
    dev = torch.device("cuda", 0)
    cfg32 = dp_f32_config()
    ae_cases = {f"tp_{case}": (ae_cfg, perceptual) for case, ae_cfg,
                perceptual in dp_ae_cases(cfg32)}
    torch.backends.cudnn.deterministic = True
    res: dict = {"pinned": {}}

    def on_card(key, rows=None):
        return torch.as_tensor(spec[key][:rows], device=dev)
    c, s = on_card("content_clean", 7), on_card("style_clean", 7)

    def tp_step(key) -> dict:
        if key == "tp_ldm":
            tr = LDMTrainer(cfg32)
            st = tr.init_state(0)
            st.model.load_state_dict(spec["ldm"])
            st, m = tr._step(st, c, s, t=on_card("t", 7).long(),
                             noise=on_card("noise", 7))
            return {"metrics": {k: v.item() for k, v in m.items()},
                    "grads": dp_grads(st.model),
                    "stats": dp_stats(st.model.decoder)}
        ae_cfg, perceptual = ae_cases[key]
        ae = AETrainer(ae_cfg, perceptual=perceptual)
        st = ae.init_state(0)
        st.model.load_state_dict(spec["ae"])
        st, loss = ae._step(st, c)
        return {"loss": loss.item(), "grads": dp_grads(st.model),
                "stats": dp_stats(st.model)}

    for tag, cases in routes.items():
        res["pinned"][tag] = {}
        for key, pinned in cases.items():
            with Routing(pinned=pinned) as g:
                out = tp_step(key)
            check(g.calls == len(pinned), f"6f {tag} {key}: {g.calls} "
                  f"calls pinned of the ranks' {len(pinned)}")
            res["pinned"][tag][key] = dict(
                out, flips=g.flips, flip_of_max=g.flip_of_max,
                routes=sum(int(np.prod(r.shape)) * (8 if kind == "relu"
                                                    else 1)
                           for kind, _, r in pinned))
    tr = LDMTrainer(cfg32)
    st = tr.init_state(0)
    st.model.load_state_dict(spec["ldm"])
    st, m = tr._step(st, on_card("sp_content"), on_card("sp_style"),
                     t=on_card("sp_t").long(), noise=on_card("sp_noise"))
    res["sp_ldm"] = {"metrics": {k: v.item() for k, v in m.items()},
                     "grads": dp_grads(st.model),
                     "stats": dp_stats(st.model.decoder)}
    ldm = build_ldm(cfg32, dtype=torch.float32, device=dev, seed=0)
    with torch.no_grad():
        out = ldm(on_card("wide"), on_card("wide_style"),
                  torch.zeros(2, dtype=torch.long, device=dev),
                  noise=on_card("wide_noise"))
    res["wide_forward"] = {k: out[k].cpu()
                           for k in ("noise_pred", "reconstructed")}
    torch.backends.cudnn.deterministic = False
    del tr, st, ldm, out, c, s
    gc.collect()
    torch.cuda.empty_cache()
    c64, s64, wide = cost_inputs(dev)
    base = torch.cuda.memory_allocated()
    res["cost"] = ldm_cost(LDMTrainer(default_config()), c64, s64,
                           Path(spec["profile"]) / "one", base)
    res["wide_step"] = wide_cost(LDMTrainer(default_config()), wide, wide,
                                 base)
    return res


def mp_spec(spec: dict, work: Path) -> None:
    """Add 6f's inputs to 6e (i)'s ``spec``: the sequence-parallel rows
    on 64 x 256, the 128 x 1024 forward's, and the cost's profile
    directory."""
    import numpy as np
    mp_rng = np.random.RandomState(23)
    spec.update(
        sp_content=mp_rng.rand(7, 64, 256, 1).astype(np.float32),
        sp_style=mp_rng.rand(7, 64, 256, 1).astype(np.float32),
        sp_t=mp_rng.randint(0, 200, 7),
        sp_noise=mp_rng.randn(7, 8, 32, 32).astype(np.float32),
        wide=mp_rng.rand(2, 128, 1024, 1).astype(np.float32),
        wide_style=mp_rng.rand(2, 128, 1024, 1).astype(np.float32),
        wide_noise=mp_rng.randn(2, 16, 128, 32).astype(np.float32),
        profile=str(work / "profile" / "model_parallel"))


def dp_mp_steps(spec: dict, res: dict) -> None:
    """6e (i)'s data-parallel steps, then, on the same two ranks and
    process group, 6f (i)'s (1, 2) mesh (``mp_steps``, its cost
    included) into ``res["mp_1x2"]``: one start of the ranks for both."""
    counted = dp_counted()
    dp_steps(spec, res)
    res.setdefault("launches", {fn.__name__: fn.launches for fn in counted})
    for fn in counted:
        fn.launches = 0
    mp = {"backend": res["backend"]}
    mp_steps(dict(spec, shape=(1, 2)), mp)
    res["mp_1x2"] = mp


def model_parallel_phase(work: Path, spec: dict, one_dp: dict,
                         card: str, ranks_1x2: list,
                         seconds_1x2: float) -> tuple:
    """Phase 6f, the model axis: parity of tensor- and sequence-parallel
    ranks against one process (6e (i)'s weights and rows in ``spec``, its
    one-process steps in ``one_dp``; ``mp_one`` after the ranks, with
    their routes pinned for the tensor-parallel steps), then their cost
    beside it.  The (1, 2) ranks ran inside 6e (i)'s ranks
    (``dp_mp_steps``: ``ranks_1x2``, in ``seconds_1x2`` with 6e (i)'s
    steps).  -> (results, launches summed over the parity ranks)."""
    import numpy as np
    import torch
    # (i) parity, f32 (TF32 off, cuDNN deterministic): ranks of this
    # script on the one card over gloo at (1, 2) and (2, 2):
    # tensor-parallel LDM, AE and distill steps on 6e (i)'s 7 real rows
    # (padded to 8 at two data indices), a sequence-parallel LDM step on
    # 64 x 256, at (1, 2) the 128 x 1024 forward on width blocks of 512
    # and then (ii)'s cost, each against one process (6e (i)'s steps and
    # ``mp_one``)
    mdir = work / "model_parallel"
    shutil.rmtree(mdir, ignore_errors=True)
    meshes = {"1x2": ranks_1x2}
    seconds = {"1x2": seconds_1x2}
    t0 = time.perf_counter()
    meshes["2x2"] = dp_spawn("mp_steps", 4, dict(spec, shape=(2, 2)),
                             mdir / "2x2")
    seconds["2x2"] = time.perf_counter() - t0
    # one process, with each mesh's routes: (1, 2)'s rank 0's; (2, 2)'s
    # ranks 0 and 2 (data indices 0 and 1, 4 rows each) joined
    r22 = meshes["2x2"]
    routes = {"1x2": meshes["1x2"][0]["routes"],
              "2x2": {key: merge_routes([r22[0]["routes"][key],
                                         r22[2]["routes"][key]], 4, 7)
                      for key in TP_CASES}}
    t0 = time.perf_counter()
    one = mp_one(spec, routes)
    seconds["one_process"] = time.perf_counter() - t0
    one.update({f"tp_{k}": one_dp[k] for k in ("ldm", "ae", "ae_plain",
                                                "distill")})
    del routes
    mp_i: dict = {}
    for tag, ranks in meshes.items():
        mp_i[tag] = {"seconds": seconds[tag], "ranks": []}
        for r, res in enumerate(ranks):
            check(res["backend"] == "gloo", "6f (i) is not on gloo")
            row = {"launches_tp": res["launches_tp"],
                   "launches_sp": res["launches_sp"],
                   "sp_block": res["sp_block"]}
            for key in TP_CASES + ("tp_distill", "sp_ldm"):
                got, want = res[key], one[key]
                row[f"{key}_loss_rel"] = (
                    max(dp_rel(got["metrics"][k], v)
                        for k, v in want["metrics"].items())
                    if "metrics" in want else dp_rel(got["loss"],
                                                     want["loss"]))
                row[f"{key}_grad_of_max"] = dp_grad_of_max_by_part(
                    got["grads"], want["grads"])
                if "stats" in want:
                    row[f"{key}_stats_rel"] = dp_stats_err(got["stats"],
                                                           want["stats"])
                if key in TP_CASES:
                    pinned = one["pinned"][tag][key]
                    row[f"{key}_pinned_grad_of_max"] = dp_grad_of_max_by_part(
                        got["grads"], pinned["grads"])
                    row[f"{key}_flips"] = {k: pinned[k] for k in (
                        "flips", "routes", "flip_of_max")}
            if "wide_forward" in res:
                for k, atol in (("reconstructed", TOL_WIDE_ATOL_REC),
                                ("noise_pred", TOL_WIDE_ATOL_EPS)):
                    got, want = res["wide_forward"][k], one["wide_forward"][k]
                    row[f"wide_{k}_excess"] = ((got - want).abs() - atol
                                               - TOL_WIDE_RTOL * want.abs()
                                               ).max().item()
                    row[f"wide_{k}_max_abs"] = (got - want).abs().max().item()
            mp_i[tag]["ranks"].append(row)
            print(f"6f (i) {tag} rank {r} of {len(ranks)} on the one card "
                  f"(gloo, f32) against one process (TP gradients against "
                  f"it with this mesh's ReLU gates and max-pool choices "
                  f"pinned; unpinned beside them): "
                  f"{ {k: v for k, v in row.items() if 'launches' not in k} }"
                  f"; launches TP {row['launches_tp']}, SP "
                  f"{row['launches_sp']}")
            for key in TP_CASES + ("tp_distill", "sp_ldm"):
                check(row[f"{key}_loss_rel"] <= TOL_DP_LOSS,
                      f"6f (i) {tag} rank {r}: {key} loss off by "
                      f"{row[f'{key}_loss_rel']:.3g} (tol {TOL_DP_LOSS})")
                held = row.get(f"{key}_pinned_grad_of_max",
                               row[f"{key}_grad_of_max"])
                for part, err in held.items():
                    tol = (TOL_AE_KL_ENCODER if key == "tp_ae"
                           and part == "encoder" else TOL_DP_GRAD)
                    check(err <= tol, f"6f (i) {tag} rank {r}: {key} {part} "
                          f"gradients off by {err:.3g} of max (tol {tol})")
                if key in TP_CASES:
                    flips = row[f"{key}_flips"]
                    check(flips["flip_of_max"] <= TOL_FLIP_OF_MAX,
                          f"6f (i) {tag}: {key} took a route "
                          f"{flips['flip_of_max']:.3g} of its input's max "
                          f"from a tie (tol {TOL_FLIP_OF_MAX})")
            for key in TP_CASES + ("sp_ldm",):
                check(row[f"{key}_stats_rel"] <= TOL_DP_STATS,
                      f"6f (i) {tag} rank {r}: {key} BatchNorm statistics "
                      f"off by {row[f'{key}_stats_rel']:.3g} "
                      f"(tol {TOL_DP_STATS})")
            for k in ("reconstructed", "noise_pred"):
                if f"wide_{k}_excess" in row:
                    check(row[f"wide_{k}_excess"] <= 0.0,
                          f"6f (i) {tag} rank {r}: the 128 x 1024 forward's "
                          f"{k} off by {row[f'wide_{k}_max_abs']:.3g}")
            for part in ("launches_tp", "launches_sp"):
                check(row[part]["fused_trunk"] > 0
                      and row[part]["normalized_mse_forward"] > 0,
                      f"6f (i) {tag} rank {r}: kernels D and E did not run "
                      f"in its {part[9:].upper()} steps")

    # (ii) cost: 20 bf16 LDM steps at the defaults, B=64 per data index,
    # under (1, 2) tensor and (1, 2) sequence parallelism (run by the
    # (1, 2) ranks above), beside one process on the same rows; then the
    # 128 x 1024 step's peak memory
    one_wide = one["wide_step"]
    mp_ii = {"seconds": seconds,
             "one_process": dict(one["cost"], wide_step=one_wide),
             "ranks": [res["cost"] for res in meshes["1x2"]]}
    x = one["cost"]
    one_ms, one_dev, one_peak = (x["ms_per_step"], x["device_ms_per_step"],
                                 x["peak_mib"])
    print(f"6f seconds (wall): {seconds}")
    print(f"time {card} 6f (ii) one process, LDM step B=64 bf16: "
          f"{one_ms:.1f} ms/step (host clock over 20), device "
          f"{one_dev:.2f} ms/step, peak memory {one_peak:.0f} MiB; "
          f"128 x 1024 step B=8: {one_wide['ms']:.1f} ms, peak memory "
          f"{one_wide['peak_mib']:.0f} MiB")
    for r, row in enumerate(mp_ii["ranks"]):
        for mode in ("tp", "sp"):
            x = row[mode]
            idle = x["idle_share"]
            coll = x["collectives_per_step"]
            print(f"time {card} 6f (ii) {mode.upper()} (1, 2) rank {r} of 2 "
                  f"on the one card (gloo, bf16, B=64): "
                  f"{x['ms_per_step']:.1f} ms/step (host clock over 20), "
                  f"device {x['device_ms_per_step']:.2f} ms/step "
                  f"(torch.profiler over 3), idle share "
                  f"{'not measured' if idle is None else f'{idle:.3f}'}, "
                  f"model axis {coll['model_bytes'] / 1e6:.2f} MB in "
                  f"{coll['model_calls']:.0f} calls per step, statistics "
                  f"and metrics all-reduced "
                  f"{coll['all_reduce_bytes'] / 1e6:.3f} MB in "
                  f"{coll['all_reduce_calls']:.0f} calls, "
                  f"DistributedDataParallel's gradients "
                  f"{x['ddp_gradient_bytes'] / 1e6:.2f} MB over a data "
                  f"group of 1, peak memory {x['peak_mib']:.0f} MiB; "
                  f"metrics { {k: round(v, 5) for k, v in x['metrics'].items()} }"
                  f"; launches {x['launches']}; top device entries "
                  f"{[(k, round(v, 3)) for k, v in x['top_kernels_ms']]}")
            check(all(np.isfinite(v) for v in x["metrics"].values()),
                  f"6f (ii) {mode} rank {r}: a non-finite loss")
            check(x["launches"]["fused_trunk"] > 0,
                  f"6f (ii) {mode} rank {r}: kernel E never ran")
        w = row["wide_step"]
        print(f"time {card} 6f (ii) SP (1, 2) rank {r}: 128 x 1024 step B=8 "
              f"bf16 on width blocks {w['block']}: {w['ms']:.1f} ms, peak "
              f"memory {w['peak_mib']:.0f} MiB per rank (one process "
              f"{one_wide['peak_mib']:.0f} MiB)")
        check(all(np.isfinite(v) for v in w["metrics"].values()),
              f"6f (ii) rank {r}: the 128 x 1024 step's loss is not finite")
    # the model peers' replicated parameters and BatchNorm statistics after
    # 24 steps on cuDNN's default algorithms: the same bits
    for mode in ("tp", "sp"):
        a, b = (row[mode]["replicated_digest"] for row in mp_ii["ranks"])
        differ = sorted(k for k in a if a[k] != b[k])
        print(f"6f (ii) {mode.upper()}: {len(a)} replicated tensors hashed "
              f"on both model peers after 24 steps, {len(differ)} differ "
              f"{differ[:5]}")
        check(set(a) == set(b) and not differ,
              f"6f (ii) {mode}: the model peers' replicated tensors differ "
              f"after 24 steps: {differ[:5]}")
    mp_launches = {k: sum(r["launches_tp"][k] + r["launches_sp"][k]
                          for t in mp_i.values() for r in t["ranks"])
                   for k in mp_i["1x2"]["ranks"][0]["launches_tp"]}
    del meshes, one
    shutil.rmtree(mdir, ignore_errors=True)
    return {"i": mp_i, "ii": mp_ii}, mp_launches


# ---- phase 6g: the reference API --------------------------------------
# VGGishFeatureLoss's three routes on the card (``resolve_impl``): the
# kernel launches each call must make, by wrapper.  Value only: E's
# value-only trunk (D's forward once per layer inside it); a gradient to
# ``predicted``: E with its backward chain (D's backward per layer); a
# gradient to ``target``: the ``layer`` route, D per layer.
REFERENCE_API_LAUNCHES = {
    "value": {"fused_trunk": 1, "normalized_mse_forward": 6,
              "normalized_mse_backward": 0},
    "pred_grad": {"fused_trunk": 1, "normalized_mse_forward": 6,
                  "normalized_mse_backward": 6},
    "target_grad": {"fused_trunk": 0, "normalized_mse_forward": 6,
                    "normalized_mse_backward": 6},
}
# The layer route's target gradient vs plain: phase 7's bar for kernel
# D's f32 target gradient, 1e-4 of its max (the trunk's maps are the
# same cuDNN convs on both routes).
TOL_TARGET_GRAD_OF_MAX = 1e-4
REFERENCE_API_BATCHES = (8, 128)   # the last is also the timed one
TOL_GRAM = 1e-5         # card vs CPU, f32 (TF32 off): sum order only
# SinusoidalPositionEmbeddings card vs CPU at t = 0..199: CUDA's expf
# rounds some of the 64 frequencies (each below 1) up to two ulps
# (2 x 2^-24) away from the CPU's, which moves t * freq by up to
# 199 * 2^-23, and each side rounds its product by up to half an ulp
# (2^-17 at 128..199); sin and cos pass the difference on.
TOL_SINUSOID = 199 * 2.0 ** -23 + 2.0 ** -16
TOL_LPIPS_CARD = TOL_EMBED   # LPIPS card vs CPU: cuDNN vs CPU sum order


def reference_api_phase(dev, card: str, trunks: dict, counts) -> tuple:
    """Phase 6g, the JAX package's loss API on the card: (i)
    ``VGGishFeatureLoss`` on kernels E and D against ``impl="plain"``,
    each of its three routes at B = 8 and 128 on an integer-valued and a
    random trunk (``trunks``: {name: VGGishFeatures state dict}), the
    launches of every call asserted, then each route timed at B = 128
    beside E's f32 bound; (ii) ``perceptual_loss``'s dispatch, and its
    cached default LPIPS on the card against the CPU; (iii)
    ``gram_matrix``, ``mel_filterbank`` and
    ``SinusoidalPositionEmbeddings``, card against CPU; (iv) the card's
    peak figures.  ``counts`` is (reset_counts, read_counts).
    -> (results, launches summed over the checked kernel calls)."""
    import torch

    from music_style_transfer_ldm_tpu_torch.audio import (
        mel_filterbank, mel,
    )
    from music_style_transfer_ldm_tpu_torch.losses import (
        VGGishFeatureLoss, gram_matrix, perceptual_loss,
    )
    from music_style_transfer_ldm_tpu_torch.losses import basic
    from music_style_transfer_ldm_tpu_torch.models import (
        SinusoidalPositionEmbeddings,
    )
    from music_style_transfer_ldm_tpu_torch.ops import fused_trunk as ft
    from music_style_transfer_ldm_tpu_torch.utils.chips import (
        deterministic_convs, peak_flops_per_sec,
    )
    reset_counts, read_counts = counts
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    res: dict = {"err": {}, "ms": {}, "plain_ms": {}, "bound_ms": {}}
    launches: dict = {}

    def inputs(trunk, B):
        if trunk == "integer":   # exact f32 maps: the routes pool alike
            return [torch.randint(0, 4, (B, 128, 128, 1), device=dev,
                                  generator=g).float() for _ in range(2)]
        return [torch.rand(B, 128, 128, 1, device=dev, generator=g)
                for _ in range(2)]

    def exact_maps(trunk):
        """The integer trunk's calls run with cuDNN off: its f32
        algorithms at B = 128 are not exact on integers (phase 3), and an
        inexact map breaks one of the many exact ties in the 2x2
        max-pools, which routes a gradient to another pixel.  PyTorch's
        own convs are cuBLAS GEMMs (TF32 off): exact sums, as kernel E's
        CUDA-core convs are, so both routes see the same maps."""
        if trunk != "integer":
            return contextlib.nullcontext()
        return torch.backends.cudnn.flags(enabled=False, allow_tf32=False)

    def run(loss, route, p, t):
        """One call on ``route``: (value, the gradient it asks for)."""
        if route == "value":
            with torch.no_grad():
                return loss(p, t).item(), None
        P = p.clone().requires_grad_(route == "pred_grad")
        T = t.clone().requires_grad_(route == "target_grad")
        v = loss(P, T)
        v.backward()
        return v.item(), (P.grad if route == "pred_grad" else T.grad)

    # (i) VGGishFeatureLoss on the kernels against impl="plain"
    losses = {}
    for trunk, sd in trunks.items():
        losses[trunk] = (VGGishFeatureLoss(params=sd, device=dev),
                         VGGishFeatureLoss(params=sd, device=dev,
                                           impl="plain"))
        for B in REFERENCE_API_BATCHES:
            p, t = inputs(trunk, B)
            for route, want_n in REFERENCE_API_LAUNCHES.items():
                kern, plain = losses[trunk]
                reset_counts()
                with exact_maps(trunk):
                    vk, gk = run(kern, route, p, t)
                n = read_counts()
                for k, c in n.items():
                    launches[k] = launches.get(k, 0) + c
                check(n == {**{k: 0 for k in n}, **want_n},
                      f"6g VGGishFeatureLoss {route} B={B}: launches {n}, "
                      f"expected {want_n}")
                reset_counts()
                with exact_maps(trunk):
                    vr, gr = run(plain, route, p, t)
                check(not any(read_counts().values()),
                      f"6g impl='plain' {route} launched a kernel")
                err = {"value": abs(vk - vr) / vr}
                ok = err["value"] <= TOL_E_VALUE
                if gk is not None:
                    err["of_max"] = ((gk - gr).abs().max()
                                     / gr.abs().max()).item()
                    err["rel_l2"] = ((gk - gr).norm() / gr.norm()).item()
                    ok = ok and (
                        err["of_max"] <= TOL_TARGET_GRAD_OF_MAX
                        if route == "target_grad" else
                        err["of_max"] <= TOL_E_GRAD_OF_MAX
                        if trunk == "integer" else
                        err["rel_l2"] <= TOL_E_REL_L2)
                if trunk == "integer" and route == "pred_grad":
                    # a reading, not a check: why exact_maps is needed
                    _, g_cudnn = run(plain, route, p, t)
                    err["plain_on_cudnn_of_max"] = (
                        (g_cudnn - gr).abs().max() / gr.abs().max()).item()
                res["err"][f"{trunk} {route} B={B}"] = err
                print(f"6g VGGishFeatureLoss {trunk} trunk {route} B={B} "
                      f"f32 128x128 vs impl='plain' on the card: "
                      f"{ {k: float(f'{v:.3g}') for k, v in err.items()} } "
                      f"(tol value {TOL_E_VALUE}; pred grad "
                      f"{TOL_E_GRAD_OF_MAX} of max on the integer trunk, "
                      f"rel L2 {TOL_E_REL_L2} on the random one; target "
                      f"grad {TOL_TARGET_GRAD_OF_MAX} of max); launches "
                      f"{ {k: v for k, v in n.items() if v} }")
                check(ok, f"6g VGGishFeatureLoss {trunk} {route} B={B} "
                          f"disagrees with impl='plain': {err}")
            del p, t
    # each route timed at B = 128 on the random trunk, beside E's f32
    # bound: its work at the f32 rate outside the tensor cores or its
    # bytes at the HBM rate
    kern, plain = losses["random"]
    B = REFERENCE_API_BATCHES[-1]
    p, t = inputs("random", B)
    P, T = p.clone().requires_grad_(True), t.clone().requires_grad_(True)

    def timed(loss, route):
        if route == "value":
            def fn():
                with torch.no_grad():
                    loss(p, t)
        elif route == "pred_grad":
            def fn():
                loss(P, t).backward()
        else:
            def fn():
                loss(p, T).backward()
        return fn

    for route in REFERENCE_API_LAUNCHES:
        cost = ft.trunk_cost(kern.module, B, 128, 128, 4, route != "value")
        res["bound_ms"][route] = 1e3 * max(cost["flops"] / H100_F32_FLOPS,
                                           cost["bytes"] / H100_BYTES)
        res["ms"][route] = cuda_ms(timed(kern, route), 3)
        res["plain_ms"][route] = cuda_ms(timed(plain, route), 2)
        via = "D per layer" if route == "target_grad" else "E"
        print(f"time {card} VGGishFeatureLoss {route} B={B} f32 128x128 "
              f"(auto: {via}): {res['ms'][route]:.3f} ms/call, "
              f"impl='plain' {res['plain_ms'][route]:.3f} ms; E's f32 "
              f"bound {res['bound_ms'][route]:.4f} ms ("
              f"{cost['flops'] / 1e12:.3f} TFLOP at "
              f"{H100_F32_FLOPS / 1e12:g} TFLOP/s)")
    del p, t, P, T

    # (ii) perceptual_loss: the extractor as given, and the cached default
    x, y = (torch.rand(8, 128, 128, 1, device=dev, generator=g)
            for _ in range(2))
    with deterministic_convs():
        dispatched = perceptual_loss(x, y, "vggish", kern).item()
        direct = kern(x, y).item()
    check(dispatched == direct, f"6g perceptual_loss(vggish) {dispatched} "
                                f"!= the extractor's {direct}")
    try:
        perceptual_loss(x, y, "vggish")
        fail("6g perceptual_loss(vggish) without an extractor did not raise")
    except ValueError:
        pass
    on_card = perceptual_loss(x, y, "lpips").item()
    cached = basic._DEFAULT_LPIPS[x.device]
    again = perceptual_loss(x, y, "lpips").item()
    check(basic._DEFAULT_LPIPS[x.device] is cached,
          "6g perceptual_loss built a second default LPIPS on the card")
    on_cpu = perceptual_loss(x.cpu(), y.cpu(), "lpips").item()
    cpu_sd = basic._DEFAULT_LPIPS[torch.device("cpu")].module.state_dict()
    same = all(torch.equal(v.cpu(), cpu_sd[k])
               for k, v in cached.module.state_dict().items())
    res["err"]["lpips_card_vs_cpu"] = abs(on_card - on_cpu) / on_cpu
    print(f"6g perceptual_loss: vggish via the dispatcher {dispatched!r} "
          f"== the extractor's {direct!r}; lpips B=8 on the card {on_card:.8g} "
          f"(again {again:.8g}, the cached module reused), on the CPU "
          f"{on_cpu:.8g} with the same seed-0 weights ({same}): rel "
          f"{res['err']['lpips_card_vs_cpu']:.3g} (tol {TOL_LPIPS_CARD})")
    check(same and res["err"]["lpips_card_vs_cpu"] <= TOL_LPIPS_CARD,
          "6g perceptual_loss(lpips) on the card disagrees with the CPU")

    # (iii) small checks, card against CPU
    f = torch.randn(8, 16, 16, 64, device=dev, generator=g)
    gc, gh = gram_matrix(f), gram_matrix(f.cpu())
    res["err"]["gram"] = ((gc.cpu() - gh).abs().max()
                          / gh.abs().max()).item()
    fb = mel_filterbank(device=dev)
    fb_same = torch.equal(fb.cpu(), torch.from_numpy(
        mel.mel_filterbank_np()))
    steps = torch.arange(200, device=dev)
    emb = SinusoidalPositionEmbeddings().to(dev)
    res["err"]["sinusoid"] = (emb(steps).cpu()
                              - emb.cpu()(steps.cpu())).abs().max().item()
    peak = peak_flops_per_sec(torch.cuda.get_device_name())
    print(f"6g gram_matrix [8,16,16,64] card vs CPU: max abs / max "
          f"{res['err']['gram']:.3g} (tol {TOL_GRAM}); mel_filterbank on "
          f"the card bit-equal to mel_filterbank_np: {fb_same}; "
          f"SinusoidalPositionEmbeddings t = 0..199: max abs "
          f"{res['err']['sinusoid']:.3g} (tol {TOL_SINUSOID}); "
          f"peak_flops_per_sec({torch.cuda.get_device_name()!r}) = {peak}")
    check(res["err"]["gram"] <= TOL_GRAM, "6g gram_matrix disagrees")
    check(fb_same, "6g mel_filterbank on the card differs from the table")
    check(res["err"]["sinusoid"] <= TOL_SINUSOID,
          "6g SinusoidalPositionEmbeddings disagrees")
    check(peak is not None, "6g utils/chips.py does not know this card")
    return res, launches


# ---- phase 9: the repo's tools on the port, each a process of its own ----

# (name, script, its arguments after the common ones) of phase 9; {w}
# is the phase's directory, the rest as ``tools_phase`` names them.
TOOL_RUNS = (
    ("load_curve_dpm", "tools/torch_serving_load_curve.py",
     ["--loads", "25,50,100", "--seconds", "3", "--autoscale", "off",
      "--sampler", "dpm++", "--out", "{w}/load_curve_dpm.json"]),
    ("load_curve_fused", "tools/torch_serving_load_curve.py",
     ["--loads", "25,50,100", "--seconds", "3", "--autoscale", "off",
      "--sampler", "fused-dpm++", "--out", "{w}/load_curve_fused.json"]),
    ("roofline", "tools/torch_roofline_b64.py",
     ["--chain", "4", "--out", "{w}/roofline.json"]),
    ("eval_transfer", "tools/torch_eval_transfer.py",
     ["--checkpoint", "{ckpt}", "--pack", "{spk}", "--pairings", "{pairs}",
      "--n-pairs", "4", "--steps", "10", "--out-dir", "{w}/eval"]),
    ("eval_generate", "tools/torch_eval_generate.py",
     ["--checkpoint", "{ckpt}", "--pack", "{spk}", "--n", "4", "--steps",
      "10", "--out", "{w}/eval/generate_eval.json"]),
    ("eval_distill_fidelity", "tools/torch_eval_distill_fidelity.py",
     ["--teacher", "{ckpt}", "--student", "{student}", "--steps", "100",
      "--sample-steps", "4", "--pack", "{spk}", "--pairings", "{pairs}",
      "--n-pairs", "4", "--out", "{w}/eval/distill_fidelity.json"]),
    ("fullscale_run", "tools/torch_fullscale_run.py",
     ["--workdir", "{w}/fullscale", "--seconds", "30", "--pairs", "256",
      "--ae-epochs", "1", "--ldm-epochs", "1", "--device-resident"]),
    ("end_to_end_demo", "examples/torch_end_to_end_demo.py",
     ["--workdir", "{w}/demo", "--epochs", "1", "--steps", "2"]),
)
TOOLS_TIMEOUT_S = 400
# The roofline's achieved rate may sit at most this far above its
# stage's bound (CUDA-event timing against counted work).
TOL_ROOFLINE = 1.05


def tools_phase(work: Path, card: str, ckpt: Path, student: Path,
                spk: Path, pairs: Path) -> dict:
    """Phase 9: every tool of ``TOOL_RUNS`` as a user runs it, all at once
    (the card shared; phase 9 checks what they produce, it does not time
    them), each in a process of its own that must exit 0, on phase 6's
    checkpoint, phase 6c's 3-step student and phase 6d's pack.  Their
    records are checked, and each process's launch line (``kernel
    launches:``) summed.  -> {tool: summary, "launches": summed}."""
    import math
    root = Path(__file__).resolve().parent
    wdir = work / "tools"
    shutil.rmtree(wdir, ignore_errors=True)
    wdir.mkdir(parents=True)
    fill = {"w": str(wdir), "ckpt": str(ckpt), "student": str(student),
            "spk": str(spk), "pairs": str(pairs)}
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = {}
    t0 = time.perf_counter()
    try:
        for name, script, argv in TOOL_RUNS:
            log = open(wdir / f"{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, str(root / script)]
                + [a.format(**fill) for a in argv],
                cwd=root, stdout=log, stderr=subprocess.STDOUT, env=env,
                start_new_session=True), log)
        deadline = time.monotonic() + TOOLS_TIMEOUT_S
        rcs, seconds = {}, {}
        while len(rcs) < len(procs) and time.monotonic() < deadline:
            for name, (proc, _) in procs.items():
                if name not in rcs and proc.poll() is not None:
                    rcs[name] = proc.returncode
                    seconds[name] = round(time.perf_counter() - t0, 1)
            time.sleep(0.2)
        for name in procs:
            rcs.setdefault(name, "timeout")
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            log.close()
    wall = time.perf_counter() - t0
    texts = {name: (wdir / f"{name}.log").read_text() for name in procs}
    for name, rc in rcs.items():
        check(rc == 0, f"9 {name} exited {rc}:\n{texts[name][-3000:]}")
    launches: dict = {}
    for name, text in texts.items():
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("kernel launches: ")]
        check(lines, f"9 {name} printed no launch line")
        for k, v in json.loads(lines[-1][len("kernel launches: "):]).items():
            launches[k] = launches.get(k, 0) + v
    out: dict = {"wall_s": round(wall, 1), "done_at_s": seconds}

    # the load curves: every request answered, none failed
    for name in ("load_curve_dpm", "load_curve_fused"):
        rec = json.loads((wdir / f"{name}.json").read_text())
        levels = [lv for run in rec["runs"] for lv in run["levels"]]
        for lv in levels:
            check(lv["errors"] == 0 and lv["completed"] == lv["sent"]
                  and lv["sent"] > 0, f"9 {name}: a level lost requests: "
                  f"{lv}")
        out[name] = [{k: lv[k] for k in (
            "offered_clips_per_s", "sent", "achieved_clips_per_s", "p50_ms",
            "p99_ms")} for lv in levels]
        print(f"tools {card} {name} (3 s a level, autoscale off, the card "
              f"shared with phase 9's other tools): {out[name]}")

    # the roofline: each stage at most its bound; kernel A's 8 launches
    rec = json.loads((wdir / "roofline.json").read_text())
    stages = rec["stages"]
    for name, st in stages.items():
        pct = st.get("pct_of_roofline")
        check(pct is not None and math.isfinite(pct)
              and 0.0 < pct <= TOL_ROOFLINE,
              f"9 roofline {name}: pct_of_roofline {pct}")
    fused = stages["fused_kernel_b64"]
    check(fused["launches"] == 8 and fused["batch_per_launch"] == 8,
          f"9 roofline: kernel A stage {fused}")
    out["roofline"] = {name: {k: st[k] for k in (
        "ms", "kernel_ms", "idle_share", "pct_of_roofline", "bound_by")}
        for name, st in stages.items()}
    print(f"tools {card} roofline B=64 --chain 4 (shared card): "
          f"{out['roofline']}")

    # the evaluations: finite metrics, the student on kernel A's route
    ev = wdir / "eval"
    tr = json.loads((ev / "transfer_eval.json").read_text())
    gen = json.loads((ev / "generate_eval.json").read_text())
    fid = json.loads((ev / "distill_fidelity.json").read_text())
    for key, val in (
            ("style_distance_reduction_pct",
             tr["style_distance_reduction_pct"]),
            ("fad_generated_vs_style_corpus",
             gen["fad_generated_vs_style_corpus"]),
            ("fad_real_vs_real_floor", gen["fad_real_vs_real_floor"]),
            ("student mse", fid["student_distilled"]["mse_vs_teacher50"]),
            ("teacher mse", fid["teacher_coarse"]["mse_vs_teacher50"])):
        check(isinstance(val, (int, float)) and math.isfinite(val),
              f"9 eval: {key} = {val}")
    check((ev / "transfer_panel.png").stat().st_size > 1000,
          "9 eval_transfer wrote no panel")
    out["evals"] = {
        "transfer": {k: tr[k] for k in (
            "style_distance_reduction_pct", "pixel_mse_transfer_vs_content",
            "vggish_multiseed_style_reduction_pct")},
        "generate": {k: gen[k] for k in (
            "fad_generated_vs_style_corpus", "fad_real_vs_real_floor",
            "fad_other_class_ceiling")},
        "fidelity": {k: fid[k] for k in ("teacher_coarse",
                                         "student_distilled")}}
    print(f"tools {card} evals (phase 6's checkpoint, 4 held-out pairs of "
          f"phase 6d's pack): {out['evals']}")

    # the full-scale recipe at toy depth, and the demo
    meas = json.loads((wdir / "fullscale" / "results"
                       / "pipeline_measurement.json").read_text())
    check(meas["pipelined_steps"] > 0 and meas["synced_steps"] > 0
          and meas["sustained_samples_per_s"] > 0,
          f"9 fullscale_run: {meas}")
    out["fullscale_run"] = meas
    print(f"tools {card} fullscale_run (30 s a voice, 256 pairs, 1 + 1 "
          f"epochs, card-resident; shared card): {meas}")
    wav = wdir / "demo" / "out" / "transferred.wav"
    check(wav.exists() and wav.stat().st_size > 10_000,
          "9 end_to_end_demo wrote no WAV")
    for fn in ("fused_ddim_sample", "fused_ddim_update",
               "fused_mel_unit_image", "normalized_mse_forward",
               "fused_trunk"):
        check(launches.get(fn, 0) > 0, f"9: no tool launched {fn}")
    out["launches"] = launches
    print(f"tools: {len(TOOL_RUNS)} processes at once, {wall:.1f} s wall "
          f"(each done at {seconds} s); launches {launches}")
    return out


def dp_worker(args) -> int:
    """A rank of phase 6e or 6f: started by the phase, never by hand."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from music_style_transfer_ldm_tpu_torch import parallel
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dp_worker == "ws1":
        check(parallel.initialize(), "no torchrun environment")
    else:
        check(parallel.initialize(args.store, args.world, args.rank,
                                  backend="gloo", device="cuda:0"),
              "the process group did not start")
    spec = torch.load(args.spec, weights_only=False)
    counted = dp_counted()
    for fn in counted:
        fn.launches = 0
    grouped = torch.distributed.is_initialized()
    res = {"backend": torch.distributed.get_backend() if grouped else None}
    {"steps_mp": dp_mp_steps, "loader": dp_loader, "ws1": dp_world_size_1,
     "mp_steps": mp_steps}[args.dp_worker](spec, res)
    torch.cuda.synchronize()
    res.setdefault("launches", {fn.__name__: fn.launches for fn in counted})
    rank = torch.distributed.get_rank() if grouped else 0
    torch.save(res, f"{args.out}.{rank}")
    print(f"6e/6f {args.dp_worker} rank {rank}: launches "
          f"{res['launches']}", flush=True)
    parallel.shutdown()
    return 0


def run_group(cmd, timeout: float, **kw) -> int:
    """Run cmd in a session of its own; on a timeout kill the session
    (a launcher's children too).  -> exit code."""
    import os
    import signal
    proc = subprocess.Popen(cmd, start_new_session=True, **kw)
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        fail(f"timed out after {timeout} s: {' '.join(map(str, cmd))}")


def dp_spawn(mode: str, world: int, spec: dict, ddir: Path,
             timeout: float = 900) -> list:
    """``world`` ranks of this script over gloo on the one card (6e (i),
    (ii)); their result dicts.  Every rank is waited for or killed."""
    import torch
    ddir.mkdir(parents=True, exist_ok=True)
    spec_path, store = ddir / f"{mode}.spec", ddir / f"{mode}.store"
    torch.save(spec, spec_path)
    store.unlink(missing_ok=True)
    out = ddir / f"{mode}.out"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dp-worker", mode,
         "--rank", str(r), "--world", str(world), "--store",
         f"file://{store}", "--spec", str(spec_path), "--out", str(out)])
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(rc == 0 for rc in rcs), f"6e {mode}: rank exit codes {rcs}")
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


def dp_rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dp_stats_err(got: dict, want: dict) -> float:
    """Max over statistics of max |got - want| / max |want|."""
    return max((got[k] - v).abs().max().item() / max(v.abs().max().item(),
                                                     1e-30)
               for k, v in want.items())


def group_norm_only() -> int:
    """``--group-norm-only``: the card, then ``group_norm_times`` and
    ``group_norm_dispatch``."""
    import torch
    from music_style_transfer_ldm_tpu_torch.utils.chips import (
        hbm_bytes_per_sec,
    )
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    out = group_norm_times(f"[{smi}]", hbm_bytes_per_sec(kind))
    out["dispatch"] = group_norm_dispatch(f"[{smi}]")
    print(json.dumps({"group_norm": out, "card": smi}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the measurements here (JSON)")
    # phase 6e starts its ranks as this script with these
    ap.add_argument("--dp-worker", choices=["steps_mp", "loader", "ws1",
                                            "mp_steps"],
                    help=argparse.SUPPRESS)
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    for flag in ("--store", "--spec"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    ap.add_argument("--group-norm-only", action="store_true",
                    help="run only phase 7's GroupNorm kernel check and "
                         "times")
    args = ap.parse_args()
    if args.dp_worker:
        return dp_worker(args)
    if args.group_norm_only:
        return group_norm_only()

    # ---- 1. device ----------------------------------------------------
    laps = Laps()
    laps.start("1")
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
    from music_style_transfer_ldm_tpu_torch.data.build_dataset import (
        chunk_audio,
    )
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
    from music_style_transfer_ldm_tpu_torch.ops._build import (
        build_host_library,
    )
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
    from music_style_transfer_ldm_tpu_torch.utils.chips import (
        hbm_bytes_per_sec, peak_flops_per_sec,
    )
    from music_style_transfer_ldm_tpu_torch.utils.profiling import (
        StepTimer, debug_mode,
    )

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    global H100_BF16_FLOPS, H100_BYTES
    H100_BF16_FLOPS, H100_BYTES = peak_flops_per_sec(kind), \
        hbm_bytes_per_sec(kind)
    check(H100_BF16_FLOPS is not None and H100_BYTES is not None,
          f"utils/chips.py has no peak figures for {kind!r}")
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
    laps.start("2")
    built: dict = {"A": {}, "B": {}, "C": {}, "D": {}, "E": {}, "S": {}}

    def nvcc_build(key, fn):
        try:
            built[key].update(fn())
        except Exception as e:  # noqa: BLE001 — reported below
            built[key]["error"] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=nvcc_build, args=a) for a in (
        ("A", fs.build_fused_sampler), ("B", build_ddim_update),
        ("C", fm.build_fused_mel_image), ("D", nm.build_normalized_mse),
        ("E", ft.build_fused_trunk),
        ("S", lambda: build_host_library("specpack.cc")))]
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
        f"{built[k]['seconds']:.1f} s (kernel {k})" for k in "ABCDE")
        + f"; host c++ {built['S']['seconds']:.1f} s (the spec-pack reader,"
        f" csrc/specpack.cc); in parallel, {build_s:.1f} s in all")
    results["build_s"] = {**{f"{'cxx' if k == 'S' else 'nvcc'}_{k.lower()}":
                             built[k]["seconds"] for k in built},
                          "all": build_s}

    # ---- 3. kernels against their plain versions -----------------------
    laps.start("3")
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ldm32 = build_ldm(dtype=torch.float32, device=dev, seed=0)
    ab = ldm32.schedule.alpha_bars_np
    x = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    e = torch.randn(8, 16, 16, 32, device=dev, generator=g)
    # the benchmark's batches too (phase 8): 4 (the 10 s clip) and 64;
    # drawn from a generator of their own, so that the later phases'
    # inputs stay as they were
    g_b = torch.Generator(device=dev)
    g_b.manual_seed(1)
    x64 = torch.randn(64, 16, 16, 32, device=dev, generator=g_b)
    e64 = torch.randn(64, 16, 16, 32, device=dev, generator=g_b)
    err_b = {}
    for xb, eb in ((x[:4], e[:4]), (x, e), (x64, e64)):
        for eps_type, ee in (("f32", eb), ("bf16", eb.bfloat16())):
            for t, eta in ((49, 0.0), (49, 0.5), (1, 0.0)):
                a_t, a_n = float(ab[t]), float(ab[t - 1])
                k = fused_ddim_update(xb, ee, a_t, a_n, eta)
                r = ddim_update_reference(xb, ee, a_t, a_n, eta)
                sc = step_scalars(a_t, a_n, eta)
                xi, x0 = xb.clone(), torch.empty_like(xb)
                ddim_update_(xi, ee, sc, x0)
                _, r0 = ddim_step_reference(xb, ee, sc)
                torch.cuda.synchronize()
                for route, got, want in (("out of place", k, r),
                                         ("in place", xi, r),
                                         ("pred_x0", x0, r0)):
                    key = f"{eps_type} {route}"
                    err_b[key] = max(err_b.get(key, 0.0),
                                     (got - want).abs().max().item())
    print(f"kernel B vs plain [B,16,16,32], B = 4, 8, 64 (eps f32 and "
          f"bf16; t = 49, 1; eta 0, 0.5): max abs err {err_b} (expected 0; "
          f"tol {TOL_KERNEL_B})")
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
    for B in (1, 3, 4, 8):
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
    for B in (1, 4, 8):      # 1 and 4: the benchmark's (phase 8)
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
    for B in (8, 64, 128):
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
    laps.start("4")
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

    # the same seeded request twice on the default engines (bf16, audio
    # on): bit for bit, on the fused route and on the scan route, and
    # generation from noise (the engines' programs run on cuDNN's
    # deterministic algorithms, utils/chips.py deterministic_convs)
    repeat = {}
    for route, eng in (("fused", engine), ("scan", scan_engine)):
        a, b = (eng.transfer_batch(reqs_c[:2], reqs_s[:2], seeds=[5, 6])
                for _ in range(2))
        repeat[route] = {k: bool(np.array_equal(a[k], b[k]))
                         for k in ("image", "audio")}
    a, b = (engine.generate(reqs_s[:1], seed=5) for _ in range(2))
    repeat["generate"] = {k: bool(np.array_equal(a[k], b[k]))
                          for k in ("image", "audio")}
    print(f"determinism: the same request twice, bit-equal image and audio "
          f"on each route: {repeat}")
    for route, same in repeat.items():
        check(all(same.values()), f"a repeated request on the {route} route "
              f"is not bit-equal: {same}")
    results["repeat_bit_equal"] = repeat

    # ---- 5. the WAV path: CLI transfer and generate, HTTP server ------
    laps.start("5")
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
    # the same command again: bit-equal WAVs (cuDNN's deterministic
    # algorithms inside cli transfer)
    cli.main(["transfer", "--checkpoint", str(ckpt), "--content",
              str(content_wav), "--style", str(content_wav), "--sampler",
              "fused", "--steps", "100", "--overlap", "0.5",
              "--phase-init", "content", "--output", str(work / "transfer2")])
    same_wav = (work / "transfer.wav").read_bytes() == (
        work / "transfer2.wav").read_bytes()
    print(f"cli transfer twice: WAVs bit-equal {same_wav}")
    check(same_wav, "cli transfer run twice wrote different WAVs")
    results["cli_transfer_repeat_bit_equal"] = same_wav
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
    laps.start("6")
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
    laps.start("6b")
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
    laps.start("6c")
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

    # ---- 6d. the data path at the reference's scale ---------------------
    laps.start("6d")
    # cli build-dataset on 4 instruments x one 30-minute WAV (kernel C at
    # B = 64), the pack, the pairings, three loaders in the same order, and
    # 20 LDM steps fed by each; data from generators of their own, so the
    # later phases' data stay those of earlier runs
    data_dir = work / "data"
    shutil.rmtree(data_dir, ignore_errors=True)
    audio_dir, imgs_dir = data_dir / "audio", data_dir / "images"
    chunk = 3 * 22050
    wav_gen = torch.Generator(device=dev)
    wav_gen.manual_seed(9)
    expected_chunks = {}
    t0 = time.perf_counter()
    for i, (inst, sr_w, chans) in enumerate((
            ("cello", 22050, 1), ("guitar", 22050, 1), ("piano", 22050, 1),
            ("violin", 44100, 2))):
        # DATA_CONTENT_S of tones whose pitch drifts, and noise, with
        # DATA_SILENCE_S of zeros at both ends (trim_silence trims them)
        n = int(DATA_CONTENT_S * sr_w)
        pad = torch.zeros(int(DATA_SILENCE_S * sr_w), chans, device=dev)
        tt = torch.arange(n, device=dev, dtype=torch.float64) / sr_w
        f0 = 110.0 * (i + 2)
        drift = torch.rand(chans, 4, device=dev, generator=wav_gen,
                           dtype=torch.float64)
        phase = 2 * np.pi * (f0 * tt[:, None] + 3.0 * torch.sin(
            2 * np.pi * (0.01 + 0.02 * drift[:, 0]) * tt[:, None]))
        y = (0.3 * torch.sin(phase) + 0.15 * torch.sin(3.1 * phase
                                                       + drift[:, 1])
             + 0.05 * torch.randn(n, chans, device=dev, generator=wav_gen,
                                  dtype=torch.float64))
        y = torch.cat([pad, y.float(), pad])
        pcm = (y.clamp(-1, 1) * 32767).to(torch.int16).cpu().numpy()
        (audio_dir / inst).mkdir(parents=True, exist_ok=True)
        wavfile.write(audio_dir / inst / f"{inst}_take1.wav", sr_w,
                      np.ascontiguousarray(pcm[:, 0]) if chans == 1 else pcm)
        # the host arithmetic: trimmed to the content (within a frame),
        # cut into 3 s chunks at 22.05 kHz, the last zero-padded
        expected_chunks[inst] = -(-int(DATA_CONTENT_S * 22050) // chunk)
    wav_s = time.perf_counter() - t0
    del y, tt, phase, pcm
    wav_len = DATA_CONTENT_S + 2 * DATA_SILENCE_S
    print(f"data path: wrote 4 seeded WAVs of {wav_len:.1f} s (3 x 22.05 "
          f"kHz mono, 1 x 44.1 kHz 16-bit "
          f"stereo; {DATA_SILENCE_S} s of silence at both ends) in "
          f"{wav_s:.1f} s; expected chunks {expected_chunks}")
    reset_counts()
    t0 = time.perf_counter()
    out_etl, _ = run_cli(cli, ["build-dataset", "--audio-dir",
                               str(audio_dir), "--output-root",
                               str(imgs_dir)])
    torch.cuda.synchronize()
    etl_s = time.perf_counter() - t0
    etl_launches = read_counts()
    etl_split = json.loads(next(
        ln for ln in out_etl.splitlines()
        if ln.startswith("ETL seconds: "))[len("ETL seconds: "):])
    counts = {d.name: len(list(d.glob("*.png")))
              for d in sorted(imgs_dir.iterdir())}
    shapes = set()
    for png_path in imgs_dir.rglob("*.png"):
        with open(png_path, "rb") as fh:
            head = fh.read(24)
        shapes.add(struct.unpack(">II", head[16:24])[::-1])   # (H, W)
    want_c = sum(-(-k // 64) for k in expected_chunks.values())
    print(f"cli build-dataset: {sum(counts.values())} PNGs {counts}, shapes "
          f"{shapes}, {etl_s:.2f} s wall; split (s) "
          f"{ {k: round(v, 3) for k, v in etl_split.items()} }; launches "
          f"{etl_launches} (kernel C expected {want_c} = sum of ceil(chunks "
          "/ 64))")
    check(counts == expected_chunks, f"build-dataset wrote {counts}, the "
          f"host arithmetic predicts {expected_chunks}")
    check(shapes == {(128, 130)}, f"PNG shapes {shapes}")
    check(etl_launches["fused_mel_unit_image"] == want_c,
          f"kernel C launched {etl_launches['fused_mel_unit_image']} times "
          f"in the ETL, expected {want_c}")
    results["launches"]["data_path_etl"] = etl_launches
    # kernel C at the ETL's batches, B = 64 and the remainder, on the
    # spectra of one file's chunks (held against the plain version, then
    # timed beside the bound)
    ap_d = AudioProcessor(device=dev)
    file0 = sorted(audio_dir.rglob("*.wav"))[0]
    chunks0 = torch.as_tensor(chunk_audio(ap_d.trim_silence(
        ap_d.load_audio(file0)[0]), 22050), device=dev)
    rem = chunks0.shape[0] % 64 or 64
    err_c64 = {}
    for B, sl in ((64, slice(0, 64)), (rem, slice(-rem, None))):
        S = power_spectrum(chunks0[sl])
        k = fm.fused_mel_unit_image(fb, S)
        r = fm.fused_mel_unit_image_reference(fb, S)
        torch.cuda.synchronize()
        d = (k - r).abs()
        err_c64[B] = {"max_abs": d.max().item(),
                      "flips": (d > 0.5 / 255.0).float().mean().item(),
                      "off_grid": (k * 255.0 - torch.round(k * 255.0)
                                   ).abs().max().item()}
        print(f"kernel C vs plain at the ETL's batch [{B},1025,130] (real "
              f"chunks of {file0.name}): {err_c64[B]} (tol "
              f"{TOL_KERNEL_C:.6g}, flips {TOL_KERNEL_C_FLIPS}, grid "
              f"{TOL_GRID})")
        check(err_c64[B]["max_abs"] <= TOL_KERNEL_C
              and err_c64[B]["flips"] <= TOL_KERNEL_C_FLIPS
              and err_c64[B]["off_grid"] <= TOL_GRID,
              f"kernel C disagrees with its plain version at B={B}")
    S64 = power_spectrum(chunks0[:64])
    c64 = {"ms": cuda_ms(lambda: fm.fused_mel_unit_image(fb, S64), 50),
           "plain_ms": cuda_ms(
               lambda: fm.fused_mel_unit_image_reference(fb, S64), 20),
           "launches_etl": etl_launches["fused_mel_unit_image"],
           "err_vs_plain": err_c64}
    band64 = fm.mel_image_band_cost(fb, 130, 64)
    bound64 = {"operations": band64["flops"] / H100_F32_FLOPS,
               "bytes": band64["bytes"] / H100_BYTES}
    c64["bound_ms"] = 1e3 * max(bound64.values())
    c64["bound_by"] = max(bound64, key=bound64.get)
    print(f"time {card} kernel C [64,1025,130] f32 (the ETL's batch): "
          f"{c64['ms'] * 1e3:.1f} us/launch back to back (CUDA events; "
          f"device-bound at this batch); plain version "
          f"{c64['plain_ms'] * 1e3:.1f} us; bound "
          f"{c64['bound_ms'] * 1e3:.3f} us ({c64['bound_by']}; "
          f"band-limited {band64['flops'] / 1e6:.2f} MFLOP, "
          f"{band64['bytes'] / 1e6:.3f} MB at {H100_BYTES / 1e12:g} TB/s)")
    del chunks0, S64

    # the pack, the pairings
    from music_style_transfer_ldm_tpu_torch.datasets import packed as pk
    spk = data_dir / "corpus.spk"
    t0 = time.perf_counter()
    check(pk.main(["--pack", str(imgs_dir), str(spk)]) == 0, "packing")
    pack_s = time.perf_counter() - t0
    nat = pk.PackedSpectrogramDataset(spk)
    ref = pk.PackedSpectrogramDataset(spk, use_native=False)
    check(nat.native, "the native spec-pack reader did not open the pack")
    idx = np.random.RandomState(10).randint(0, len(nat), 1024)
    same = {}
    for dtype in ("uint8", "float32"):
        (xn, yn), (xr, yr) = (nat.gather(idx, dtype=dtype),
                              ref.gather(idx, dtype=dtype))
        same[dtype] = bool(np.array_equal(xn, xr) and np.array_equal(yn, yr))
    print(f"pack: {len(nat)} items, {spk.stat().st_size / 1e6:.1f} MB, "
          f"{pack_s:.2f} s (python -m ...datasets.packed --pack); reader "
          f"{'native' if nat.native else 'numpy'} (csrc/specpack.cc); native "
          f"vs numpy gathers of 1,024 seeded indices bit-equal {same}")
    check(all(same.values()), "the native and numpy readers disagree")
    nat.close()
    pairs_csv = data_dir / "pairs.csv"
    run_cli(cli, ["generate-pairings", "--root", str(imgs_dir), "--output",
                  str(pairs_csv), "--num-pairs", "15000"])

    # three loaders over the first 20 batches of the seed-0 epoch
    from music_style_transfer_ldm_tpu_torch.datasets import (
        BatchLoader, DevicePairLoader, DeviceResidentPairs,
        PackedBatchLoader, PackedPairDataset, SpectrogramPairDataset,
    )
    from music_style_transfer_ldm_tpu_torch.training.state import (
        as_unit_images, to_device,
    )
    order = np.random.RandomState(0).permutation(15000)[:20 * 128]
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    resident = DeviceResidentPairs(spk, pairs_csv)
    corpus_mib = resident.nbytes / 2**20
    print(f"DeviceResidentPairs: {tuple(resident.images.shape)} uint8 on "
          f"the card, {resident.nbytes} B ({corpus_mib:.1f} MiB; allocated "
          f"{(torch.cuda.memory_allocated() - base_mem) / 2**20:.1f} MiB)")
    names = ("png", "packed", "device")

    def loader(name, ids):
        if name == "png":
            return BatchLoader(SpectrogramPairDataset(imgs_dir, pairs_csv),
                               128, indices=ids, shuffle=False)
        if name == "packed":
            return PackedBatchLoader(PackedPairDataset(spk, pairs_csv), 128,
                                     indices=ids, shuffle=False,
                                     dtype="uint8")
        return DevicePairLoader(resident, 128, indices=ids, shuffle=False)

    diffs = []
    for batches in zip(*(loader(name, order) for name in names)):
        seen = [(as_unit_images(to_device(c, dev)),
                 as_unit_images(to_device(s, dev)), list(lc), list(ls))
                for (c, lc), (s, ls) in batches]
        for other in seen[1:]:
            diffs.append(max((other[0] - seen[0][0]).abs().max().item(),
                             (other[1] - seen[0][1]).abs().max().item()))
            check(other[2:] == seen[0][2:], "the loaders' labels differ")
    table = as_unit_images(torch.arange(256, device=dev).to(torch.uint8))
    scalar_div = torch.arange(256, device=dev).float() / 255.0
    print(f"three loaders (BatchLoader over PNGs, PackedBatchLoader uint8, "
          f"DevicePairLoader), first {len(diffs) // 2} batches of B=128: max "
          f"abs difference after as_unit_images {max(diffs)} (must be 0); "
          f"on the card k / 255.0 by a Python number differs from the "
          f"k / 255 table at {(table != scalar_div).sum().item()} of 256 k")
    check(len(diffs) == 40 and max(diffs) == 0.0,
          "the three loaders' batches differ")

    data_times = {"corpus_mib": corpus_mib, "etl_s": etl_s,
                  "etl_split_s": etl_split, "pack_s": pack_s,
                  "kernel_c_b64": c64, "loader_ms": {}, "step": {}}
    for name in names:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_b = sum(1 for _ in loader(name, order))
        torch.cuda.synchronize()
        data_times["loader_ms"][name] = 1e3 * (time.perf_counter() - t0) / n_b
    # the card's share of a DevicePairLoader batch: its two index_selects
    items = torch.randint(0, len(resident.images), (2, 128), device=dev,
                          generator=g)
    data_times["device_gather_card_us"] = device_us(
        lambda: (torch.index_select(resident.images, 0, items[0]),
                 torch.index_select(resident.images, 0, items[1])))
    print(f"time {card} loaders alone, ms per batch of 128 pairs over 20 "
          f"batches (host clock, ending in a synchronise): "
          f"{ {k: round(v, 3) for k, v in data_times['loader_ms'].items()} }"
          f"; DevicePairLoader's two index_selects "
          f"{data_times['device_gather_card_us']:.2f} us of card time per "
          "batch (CUDA events, queued)")
    # the corpus leaves the card until the device-fed steps, so that each
    # loader's peak memory holds only what that loader keeps there
    del resident, items

    # 20 LDM steps at B=128, bf16, the defaults, fed by each loader
    trainer_d = LDMTrainer(default_config())
    state_d, _ = trainer_d.train_epoch(trainer_d.init_state(0), loader(
        "packed", order[:256]))                    # warm-up, 2 steps
    reset_counts()
    for name in names:
        torch.cuda.synchronize()
        if name == "device":
            resident = DeviceResidentPairs(spk, pairs_csv)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state_d, m_d = trainer_d.train_epoch(state_d, loader(name, order))
        torch.cuda.synchronize()
        r = data_times["step"][name] = {
            "ms": 1e3 * (time.perf_counter() - t0) / 20,
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "metrics": m_d}
        check(all(np.isfinite(v) for v in m_d.values()),
              f"a non-finite loss fed by the {name} loader")
        box_d = [state_d]

        def five_steps(name=name):
            box_d[0], _ = trainer_d.train_epoch(box_d[0],
                                                loader(name, order[:640]))
        d_launched = nm.normalized_mse_forward.launches
        d_kernels = profiled_kernels(five_steps,
                                     work / "profile" / f"data_{name}")
        # the profile's coverage: kernel D's launches it saw of those made
        r["profile_saw_d"] = [
            sum(n for _, k, n in d_kernels if "nm_forward_kernel" in k),
            nm.normalized_mse_forward.launches - d_launched]
        state_d = box_d[0]
        r["device_ms"] = sum(us for us, *_ in d_kernels) / 1e3 / 5
        r["idle_share"] = 1.0 - r["device_ms"] / r["ms"]
        r["top_kernels_ms"] = [(k, us / 1e3 / 5)
                               for us, k, _ in d_kernels[:6]]
        print(f"time {card} LDM step B=128 bf16 fed by {name}: {r['ms']:.1f}"
              f" ms/step (host clock over 20 steps, train_epoch, ending in a"
              f" synchronise), device {r['device_ms']:.2f} ms/step "
              f"(torch.profiler over 5; it saw {r['profile_saw_d'][0]} of "
              f"{r['profile_saw_d'][1]} kernel D launches), idle share "
              f"{r['idle_share']:.3f}, peak memory {r['peak_mib']:.0f} MiB "
              f"(+{r['peak_mib'] - data_times['step']['png']['peak_mib']:.1f}"
              f" over the PNG-fed step); epoch metrics "
              f"{ {k: round(v, 5) for k, v in m_d.items()} }; top device "
              f"entries (ms/step) "
              f"{[(k[:50], round(v, 3)) for k, v in r['top_kernels_ms']]}")
    step_launches = read_counts()
    print(f"data path, 75 LDM steps (60 timed, 15 profiled): launches "
          f"{step_launches}")
    for fn in (nm.normalized_mse_forward, ft.fused_trunk):
        check(step_launches[fn.__name__] > 0,
              f"{fn.__name__} never ran in the loaders' LDM steps")
    results["launches"]["data_path_steps"] = step_launches
    results["max_abs_err"]["data_path"] = {"kernel_c_etl_batches": err_c64,
                                           "loaders": max(diffs)}
    results["data_path"] = data_times
    del resident, trainer_d, state_d, box_d
    shutil.rmtree(audio_dir, ignore_errors=True)

    # ---- 6e. the data-parallel path ------------------------------------
    laps.start("6e (i)")
    # (i) two ranks of this script on the one card over gloo (CUDA
    # tensors): f32 LDM, AE and distill steps on a global batch of 8 with
    # 7 real rows, each against the one-process step on the 7 rows
    pdir = work / "data_parallel"
    shutil.rmtree(pdir, ignore_errors=True)
    dp_rng = np.random.RandomState(21)
    cfg32 = dp_f32_config()
    spec = {"n_real": 7}
    for tag, filler in (("clean", None), ("garbage", 10.0)):
        for key in ("content", "style"):
            a = dp_rng.rand(8, 128, 128, 1).astype(np.float32)
            if tag == "garbage":
                a = spec[f"{key}_clean"].copy()
                a[7] = filler * dp_rng.rand(128, 128, 1)
            else:
                a[7] = a[6]
            spec[f"{key}_{tag}"] = a
    spec["t"] = dp_rng.randint(0, 200, 8)
    spec["noise"] = dp_rng.randn(8, 16, 16, 32).astype(np.float32)
    spec["segment"] = dp_rng.randint(0, 2, 8)
    spec["d_noise"] = dp_rng.randn(8, 16, 16, 32).astype(np.float32)
    ldm_one = build_ldm(cfg32, dtype=torch.float32, device=dev, seed=0)
    spec["ldm"] = {k: v.cpu() for k, v in ldm_one.state_dict().items()}
    ae_one = AETrainer(cfg32).init_state(0).model
    spec["ae"] = {k: v.cpu() for k, v in ae_one.state_dict().items()}
    del ldm_one, ae_one
    # the same two ranks then run 6f (i)'s (1, 2) mesh (``dp_mp_steps``)
    mp_spec(spec, work)
    t0 = time.perf_counter()
    ranks = dp_spawn("steps_mp", 2, spec, pdir)
    steps_s = time.perf_counter() - t0
    ranks_1x2 = [r.pop("mp_1x2") for r in ranks]
    # the one-process steps on the 7 real rows
    torch.backends.cudnn.deterministic = True

    def real(key):
        return torch.as_tensor(spec[key][:7], device=dev)
    one = {}
    tr = LDMTrainer(cfg32)
    st = tr.init_state(0)
    st.model.load_state_dict(spec["ldm"])
    st, m = tr._step(st, real("content_clean"), real("style_clean"),
                     t=real("t").long(), noise=real("noise"))
    one["ldm"] = {"metrics": {k: v.item() for k, v in m.items()},
                  "grads": dp_grads(st.model),
                  "stats": dp_stats(st.model.decoder)}
    for case, ae_cfg, perceptual in dp_ae_cases(cfg32):
        ae = AETrainer(ae_cfg, perceptual=perceptual)
        st = ae.init_state(0)
        st.model.load_state_dict(spec["ae"])
        st, loss = ae._step(st, real("content_clean"))
        one[case] = {"loss": loss.item(), "grads": dp_grads(st.model),
                     "stats": dp_stats(st.model)}
    dist = ProgressiveDistiller(cfg32, t_max=100)
    student = build_ldm(cfg32, dtype=torch.float32, device=dev, seed=0)
    student.load_state_dict(spec["ldm"])
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, 4, 2, 1e-4)
    seg7, dn7 = real("segment").long(), real("d_noise")
    dist.draws = lambda *a: (seg7, dn7)
    loss = dist.step(student, stage, real("content_clean"),
                     real("style_clean"), 0, 0)
    one["distill"] = {"loss": loss.item(), "grads": dp_grads(student.unet)}
    torch.backends.cudnn.deterministic = False
    del tr, ae, dist, student, stage, st
    dp_i = {"seconds": steps_s, "ranks": []}
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo", "6e (i) is not on gloo")
        row = {"launches": res["launches"]}
        for case in ("ldm", *AE_CASES, "distill"):
            got = res["ldm_clean" if case == "ldm" else case]
            want = one[case]
            if case == "ldm":
                row["ldm_loss_rel"] = max(dp_rel(got["metrics"][k], v)
                                          for k, v in want["metrics"].items())
            else:
                row[f"{case}_loss_rel"] = dp_rel(got["loss"], want["loss"])
            row[f"{case}_grad_of_max"] = grad_err_of_max(got["grads"],
                                                         want["grads"])
            if "stats" in want:
                row[f"{case}_stats_rel"] = dp_stats_err(got["stats"],
                                                        want["stats"])
        row["ae_grad_of_max_by_part"] = {
            case: dp_grad_of_max_by_part(res[case]["grads"],
                                         one[case]["grads"])
            for case in AE_CASES}
        row["garbage_rel"] = max(
            dp_rel(res["ldm_garbage"]["metrics"][k], v)
            for k, v in res["ldm_clean"]["metrics"].items())
        dp_i["ranks"].append(row)
        print(f"6e (i) rank {r} of 2 on the one card (gloo, f32, global B=8"
              f" with 7 real rows) against one process on the 7 rows: "
              f"{ {k: v for k, v in row.items() if k != 'launches'} }; "
              f"launches {row['launches']}")
        for case in ("ldm", *AE_CASES, "distill"):
            check(row[f"{case}_loss_rel"] <= TOL_DP_LOSS,
                  f"6e (i) rank {r}: {case} loss off by "
                  f"{row[f'{case}_loss_rel']:.3g} (tol {TOL_DP_LOSS})")
        for case in ("ldm", "distill"):
            check(row[f"{case}_grad_of_max"] <= TOL_DP_GRAD,
                  f"6e (i) rank {r}: {case} gradients off by "
                  f"{row[f'{case}_grad_of_max']:.3g} of max "
                  f"(tol {TOL_DP_GRAD})")
        for case, parts in row["ae_grad_of_max_by_part"].items():
            for part, err in parts.items():
                tol = (TOL_AE_KL_ENCODER if part == "encoder"
                       and case in ("ae", "ae_no_lpips") else TOL_DP_GRAD)
                check(err <= tol, f"6e (i) rank {r}: {case} {part} "
                      f"gradients off by {err:.3g} of max (tol {tol})")
        for case in ("ldm", *AE_CASES):
            check(row[f"{case}_stats_rel"] <= TOL_DP_STATS,
                  f"6e (i) rank {r}: {case} BatchNorm statistics off by "
                  f"{row[f'{case}_stats_rel']:.3g} (tol {TOL_DP_STATS})")
        check(row["garbage_rel"] <= TOL_DP_GARBAGE,
              f"6e (i) rank {r}: garbage in the pad row moved a metric by "
              f"{row['garbage_rel']:.3g} (tol {TOL_DP_GARBAGE})")
        check(res["launches"]["fused_trunk"] > 0
              and res["launches"]["normalized_mse_forward"] > 0,
              f"6e (i) rank {r}: kernels D and E did not run")
    for case in ("ldm_clean", *AE_CASES):
        for k, v in ranks[0][case]["stats"].items():
            check(torch.equal(ranks[1][case]["stats"][k], v),
                  f"6e (i): the ranks' {case} statistics differ at {k}")
    del ranks

    laps.start("6e (ii)")
    # (ii) 20 bf16 LDM steps at the defaults, global B=128 as 2 x 64, fed
    # by DevicePairLoader(mesh=) over the card-resident corpus
    t0 = time.perf_counter()
    ranks = dp_spawn("loader", 2, {
        "spk": str(spk), "pairs": str(pairs_csv), "order": order,
        "profile": str(work / "profile" / "data_parallel")}, pdir)
    loader_s = time.perf_counter() - t0
    dp_ii = {"seconds": loader_s,
             "ranks": [dict(res["loader"], launches=res["launches"])
                       for res in ranks]}
    for r, row in enumerate(dp_ii["ranks"]):
        idle = row["idle_share"]
        print(f"time {card} 6e (ii) rank {r} of 2 on the one card (gloo, "
              f"bf16, B=64 per rank, DevicePairLoader): "
              f"{row['ms_per_step']:.1f} ms/step (host clock over 20 steps),"
              f" device {row['device_ms_per_step']:.2f} ms/step "
              f"(torch.profiler over 3), idle share "
              f"{'not measured' if idle is None else f'{idle:.3f}'}, "
              f"{row['allreduce_bytes_per_step'] / 1e6:.2f} MB all-reduced "
              f"per step ({row['ddp_gradient_bytes'] / 1e6:.2f} MB of "
              f"gradients in DistributedDataParallel's buckets, "
              f"{row['other_allreduce_calls_per_step']:.0f} other calls), "
              f"peak memory {row['peak_mib']:.0f} MiB; metrics "
              f"{ {k: round(v, 5) for k, v in row['metrics'].items()} }; "
              f"launches {row['launches']}; top device entries "
              f"{[(k, round(v, 3)) for k, v in row['top_kernels_ms']]}")
        check(all(np.isfinite(v) for v in row["metrics"].values()),
              f"6e (ii) rank {r}: a non-finite loss")
        check(row["launches"]["fused_trunk"] > 0,
              f"6e (ii) rank {r}: kernel E never ran")
    check(dp_ii["ranks"][0]["metrics"] == dp_ii["ranks"][1]["metrics"],
          "6e (ii): the ranks report different global metrics")
    del ranks

    laps.start("6e (iii)")
    # (iii) torch.distributed.run at world size 1 on nccl: the CLI as a
    # user runs it (2 steps at B=128), then the data-parallel machinery
    # against the plain trainer
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(Path(__file__).resolve().parent) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1"]
    t0 = time.perf_counter()
    rc = run_group(torchrun + [
        "-m", "music_style_transfer_ldm_tpu_torch.cli", "train", "--model",
        "ldm", "--data-root", str(imgs), "--pairing-file",
        str(tdir / "pairs.csv"), "--epochs", "1", "--out-dir",
        str(pdir / "cli_run")], 900, env=env,
        cwd=str(Path(__file__).resolve().parent))
    cli_dp_s = time.perf_counter() - t0
    check(rc == 0, f"6e (iii): torchrun cli train returned {rc}")
    dp_ckpt = torch.load(pdir / "cli_run" / "ldm_final.pt",
                         map_location="cpu", weights_only=True)
    rows = (pdir / "cli_run" / "metrics.csv").read_text().splitlines()
    logged = dict(zip(rows[0].split(","), map(float, rows[-1].split(","))))
    check(dp_ckpt["step"] == 2, f"6e (iii): {dp_ckpt['step']} steps")
    check(all(np.isfinite(logged[k]) for k in (
        "total_loss", "compression_loss", "denoising_loss", "style_loss")),
        "6e (iii): a non-finite loss")
    torch.save({}, pdir / "ws1.spec")
    # the rank itself with the environment torchrun gives a rank of one
    # (parallel.initialize's env:// path on nccl): a second launch of
    # torchrun's agent cost 15-18 s and drove nothing more.  MASTER_PORT
    # 0: the rank's own store binds a port the system picks, so no other
    # process can take it between a probe and the bind
    rc = run_group([
        sys.executable, str(Path(__file__).resolve()), "--dp-worker", "ws1",
        "--spec", str(pdir / "ws1.spec"), "--out", str(pdir / "ws1.out")],
        900, env={**env, "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                  "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                  "MASTER_PORT": "0"})
    check(rc == 0, f"6e (iii): the world-size-1 rank returned {rc}")
    ws1 = torch.load(pdir / "ws1.out.0", weights_only=False)
    check(ws1["ws1"]["backend"] == "nccl", "6e (iii) is not on nccl")
    dp_iii = {"cli_seconds": cli_dp_s, "cli_metrics": logged,
              **ws1["ws1"], "launches": ws1["launches"]}
    print(f"time {card} 6e (iii) torch.distributed.run --nproc-per-node 1 "
          f"cli train --model ldm (nccl, 2 steps at B=128, bf16): "
          f"{cli_dp_s:.1f} s wall, step {dp_ckpt['step']}, metrics "
          f"{ {k: round(v, 5) for k, v in logged.items()} }; LDM step "
          f"B=128 bf16, ms/step over 10 (host clock), runs in the order "
          f"plain, dp, dp, plain: data-parallel machinery at world size 1 "
          f"{[round(v, 2) for v in dp_iii['ms_per_step']['dp']]}, plain "
          f"trainer {[round(v, 2) for v in dp_iii['ms_per_step']['plain']]}"
          f"; launches {dp_iii['launches']}")

    laps.start("6e (iv)")
    # (iv) the engine over two replicas on the one card, f32, against the
    # single-replica scan engine, cuDNN deterministic: its other
    # algorithms move an f32 image by an ulp from run to run, on one
    # replica as on two, and Griffin-Lim turns that into ~1e-3 of audio
    # (tools/torch_replica_spread.py). A replica's batch is half the
    # bucket's, and cuDNN picks its algorithm by batch, so the replicas
    # are held exactly to one replica at their batch and the audio to
    # one replica at the whole bucket within that replica's own spread
    # between the two batches.
    torch.backends.cudnn.deterministic = True
    from music_style_transfer_ldm_tpu_torch.parallel import make_mesh
    card0 = torch.device("cuda", 0)
    eng_m = InferenceEngine(ldm32, EngineConfig(sampler="fused"),
                            mesh=make_mesh((2, 1), devices=[card0, card0]))
    check(eng_m.config.batch_buckets == (2, 4, 8)
          and not any(eng_m.uses_fused(b) for b in (2, 4, 8)),
          "6e (iv): buckets not rounded or the fused route taken")
    eng_1 = InferenceEngine(ldm32, EngineConfig(sampler="ddim"))
    eng_1.warmup()
    reset_counts()
    eng_m.warmup()
    wav = (0.3 * np.sin(2 * np.pi * 220.0 * np.arange(66150) / 22050.0)
           ).astype(np.float32)[None]
    eng_m.ap.waveform_batch_to_unit_images(wav)
    dp_iv = {"buckets": {}}
    meshed = {}
    for b in (1, 3, 4, 8):
        t0 = time.perf_counter()
        meshed[b] = eng_m.transfer_batch(reqs_c[:b], reqs_s[:b],
                                         seeds=40 + np.arange(b))
        dp_iv["buckets"][b] = {"ms_mesh": 1e3 * (time.perf_counter() - t0)}
    serve_launches = read_counts()
    print(f"6e (iv) launches (warm-up, WAV front end, 4 transfers): "
          f"{serve_launches}")
    check(serve_launches["fused_ddim_sample"] == 0,
          "6e (iv): kernel A ran under a mesh")
    check(serve_launches["fused_ddim_update"] > 0
          and serve_launches["fused_mel_unit_image"] > 0,
          "6e (iv): kernels B and C did not run")
    for b, got in meshed.items():
        t0 = time.perf_counter()
        want = eng_1.transfer_batch(reqs_c[:b], reqs_s[:b],
                                    seeds=40 + np.arange(b))
        row = dp_iv["buckets"][b]
        row["ms_one"] = 1e3 * (time.perf_counter() - t0)
        # one replica on each replica's block of the padded bucket: the
        # same rows at the same batch as each replica
        bucket = min(k for k in eng_m.config.batch_buckets if k >= b)
        idx, half = np.minimum(np.arange(bucket), b - 1), bucket // 2
        blocks = [eng_1.transfer_batch(reqs_c[idx[i:i + half]],
                                       reqs_s[idx[i:i + half]],
                                       seeds=40 + idx[i:i + half])
                  for i in (0, half)]
        for key in ("image", "audio"):
            block = np.concatenate([o[key] for o in blocks])[:b]
            row[f"{key}_err"] = float(np.abs(got[key] - want[key]).max())
            row[f"{key}_vs_blocks"] = float(np.abs(got[key] - block).max())
            row[f"{key}_batch_spread"] = float(
                np.abs(block - want[key]).max())
        print(f"time {card} 6e (iv) {b} request(s), bucket {bucket}: two "
              f"replicas on the one card {row['ms_mesh']:.1f} ms, one "
              f"replica {row['ms_one']:.1f} ms (host clock, transfer_batch "
              f"with audio, f32, cuDNN deterministic); max abs difference "
              f"from one replica: image {row['image_err']:.3g}, audio "
              f"{row['audio_err']:.3g}; from one replica on each block of "
              f"{half}: image {row['image_vs_blocks']:.3g}, audio "
              f"{row['audio_vs_blocks']:.3g} (tol {TOL_DP_SERVE}); one "
              f"replica's blocks from its whole bucket: image "
              f"{row['image_batch_spread']:.3g}, audio "
              f"{row['audio_batch_spread']:.3g}")
        check(row["image_err"] <= TOL_DP_SERVE,
              f"6e (iv): bucket of {b}: image off by {row['image_err']}")
        for key in ("image", "audio"):
            check(row[f"{key}_vs_blocks"] <= TOL_DP_SERVE,
                  f"6e (iv): bucket of {b}: the replicas' {key} off one "
                  f"replica's at their batch by {row[f'{key}_vs_blocks']}")
        check(row["audio_err"] <= row["audio_batch_spread"] + TOL_DP_SERVE,
              f"6e (iv): bucket of {b}: audio off by {row['audio_err']}, "
              f"beyond one replica's own spread between batches "
              f"{row['audio_batch_spread']}")
    torch.backends.cudnn.deterministic = False
    del eng_m, eng_1
    rank_launches = {k: sum(r["launches"][k] for r in dp_i["ranks"])
                     + sum(r["launches"][k] for r in dp_ii["ranks"])
                     for k in dp_i["ranks"][0]["launches"]}
    results["launches"]["data_parallel_ranks"] = rank_launches
    results["launches"]["data_parallel_serving"] = serve_launches
    results["data_parallel"] = {"i": dp_i, "ii": dp_ii, "iii": dp_iii,
                                "iv": dp_iv}
    shutil.rmtree(pdir, ignore_errors=True)

    # ---- 6f. the model axis: tensor and sequence parallelism -----------
    laps.start("6f")
    results["model_parallel"], results["launches"]["model_parallel_ranks"] = \
        model_parallel_phase(work, spec, one, card, ranks_1x2, steps_s)

    # ---- 6g. the reference API -------------------------------------------
    laps.start("6g")
    results["reference_api"], results["launches"]["reference_api"] = \
        reference_api_phase(dev, card, {"integer": ivgg.state_dict(),
                                        "random": vgg32.state_dict()},
                            (reset_counts, read_counts))

    # ---- 7. times -------------------------------------------------------
    laps.start("7")
    results["group_norm"] = group_norm_times(card, H100_BYTES)
    results["group_norm"]["dispatch"] = group_norm_dispatch(card)
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
            "device_us": device_us(lambda: ddim_update_(xw, ee, sc49)),
            "host_us": host_us(lambda: ddim_update_(xw, ee, sc49)),
            "plain_us": 1e3 * cuda_ms(
                lambda: ddim_step_reference(xw, ee, sc49), 200),
            "bound_us": 1e6 * max(nb * (8 + ee.element_size()) / H100_BYTES,
                                  6 * nb / H100_F32_FLOPS)}
        print(f"time {card} kernel B [8,16,16,32] ddim_update_ (in place, "
              f"the sampler's entry), eps {eps_type}: "
              f"{r['back_to_back_us']:.2f} us/launch back to back, device "
              f"{r['device_us']:.3f} us per launch (CUDA events, queued), host "
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
    # the determinism repair's cost: the same requests as shipped (the
    # engines' programs on cuDNN's deterministic algorithms) and on
    # cuDNN's default choice, by swapping torch.backends.cudnn.flags (which
    # utils/chips.py deterministic_convs calls) for the duration; in turns
    real_flags = torch.backends.cudnn.flags

    @contextlib.contextmanager
    def default_algorithms(**kw):
        with real_flags(**dict(kw, deterministic=False)):
            yield
    det = times["determinism_request_s"] = {}
    for B in (1, 8):
        for route, eng in (("fused", engine), ("scan", scan_engine)):
            row = det[f"{route}_b{B}"] = {"deterministic": [], "default": []}
            for mode in ("deterministic", "default", "default",
                         "deterministic"):
                if mode == "default":
                    torch.backends.cudnn.flags = default_algorithms
                try:
                    t0 = time.perf_counter()
                    eng.transfer_batch(reqs_c[:B], reqs_s[:B],
                                       seeds=np.arange(B))
                    row[mode].append(time.perf_counter() - t0)
                finally:
                    torch.backends.cudnn.flags = real_flags
            print(f"time {card} engine transfer_batch B={B} ({route} route "
                  f"engine, bf16, audio on), runs deterministic, default, "
                  f"default, deterministic: cuDNN deterministic "
                  f"{[round(x, 4) for x in row['deterministic']]} s, "
                  f"cuDNN default {[round(x, 4) for x in row['default']]} s")
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
            lambda: fm.fused_mel_unit_image(fb, S))
        times.setdefault("kernel_c_host_us", {})[B] = host_us(
            lambda: fm.fused_mel_unit_image(fb, S))
        chunks = 0.3 * torch.randn(B, 66150, device=dev, generator=g)
        times["front_end_ms_per_chunk"][B] = cuda_ms(
            lambda: ap.waveform_batch_to_unit_images(chunks), 50) / B
        print(f"time {card} kernel C [{B},1025,130] f32: "
              f"{times['kernel_c_ms'][B] * 1e3:.1f} us/launch back to back, "
              f"device {times['kernel_c_device_us'][B]:.2f} us per launch "
              f"(CUDA events, queued), host "
              f"{times['kernel_c_host_us'][B]:.2f} us "
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
    for B in (8, 64, 128):
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
                  f"{cost['flops'] / 1e12:.3f} TFLOP at {H100_BF16_FLOPS / 1e12:g} TFLOP/s)")
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
          f"(operations: {cost['flops'] / 1e12:.4f} TFLOP at {H100_F32_FLOPS / 1e12:g} TFLOP/s)")
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
    for dev_us, key, _ in kernels_us:
        device_total += dev_us
        name = next((gname for gname, keys in groups.items()
                     if any(k in key for k in keys)), "other")
        by_group[name] = by_group.get(name, 0.0) + dev_us
    print(f"profile {card} one training step B=128 bf16: device time "
          f"{device_total / 1e3:.2f} ms; by group (ms) "
          f"{ {k: round(v / 1e3, 2) for k, v in by_group.items()} }; top "
          f"kernels (ms) "
          f"{[(k[:60], round(v / 1e3, 2)) for v, k, _ in kernels_us[:8]]}")
    times["train_step_profile"] = {"device_ms": device_total / 1e3,
                                   "groups_ms": {k: v / 1e3 for k, v in
                                                 by_group.items()},
                                   "top_kernels_ms": [
                                       (k, v / 1e3) for v, k, _ in
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
        r["device_ms"] = sum(us for us, *_ in d_kernels) / 1e3
        r["idle_share"] = 1.0 - r["device_ms"] / r["ms"]
        r["top_kernels_ms"] = [(k, us / 1e3) for us, k, _ in d_kernels[:6]]
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
        r["device_ms"] = sum(us for us, *_ in ae_kernels) / 1e3
        r["idle_share"] = 1.0 - r["device_ms"] / r["ms"]
        r["top_kernels_ms"] = [(k, us / 1e3) for us, k, _ in ae_kernels[:6]]
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
          f"{H100_BYTES / 1e12:g} TB/s); backward to the target {d32['bwd_ms']:.3f} ms, "
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

    # ---- 8. the benchmark ---------------------------------------------
    laps.start("8")
    from music_style_transfer_ldm_tpu_torch import benchmarks
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "music_style_transfer_ldm_tpu_torch.cli",
         "bench"], cwd=Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    bench_s = time.perf_counter() - t0
    tail = proc.stderr[-3000:]
    check(proc.returncode == 0,
          f"cli bench exited {proc.returncode}:\n{tail}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    check(lines, f"cli bench printed no JSON line:\n{tail}")
    line = json.loads(lines[-1])
    keys = benchmarks.HEADLINE_KEYS + benchmarks.Emitter._SECONDARY_KEYS
    check(line.get("metric") == "ddim_step_ms" and line.get("unit") == "ms",
          f"cli bench's headline is not ddim_step_ms: {line}")
    bad = [k for k in keys if k not in ("metric", "unit") and not (
        isinstance(line.get(k), (int, float)) and math.isfinite(line[k])
        and line[k] > 0)]
    check(not bad, f"cli bench's last line lacks or mis-states {bad}")
    check(all(line[k] <= 1.0 for k in ("mfu_transfer_b64",
                                       "mfu_train_b128")),
          "an MFU above 1")
    traj_ms = line["value"] * 49
    check(abs(traj_ms - times["kernel_a_ms"][1])
          <= 0.1 * times["kernel_a_ms"][1],
          f"cli bench's value x 49 = {traj_ms:.3f} ms is not within 10 % "
          f"of phase 7's kernel A trajectory, "
          f"{times['kernel_a_ms'][1]:.3f} ms")
    launch_lines = [ln for ln in proc.stderr.splitlines()
                    if ln.startswith("kernel launches: ")]
    check(launch_lines, "cli bench printed no launch line")
    bench_launches = json.loads(launch_lines[-1][len("kernel launches: "):])
    for names in (("fused_ddim_sample",), ("fused_ddim_update",),
                  ("normalized_mse_forward", "normalized_mse_backward"),
                  ("fused_trunk",)):
        check(sum(bench_launches[n] for n in names) > 0,
              f"cli bench never launched {names}")
    results["launches"]["bench"] = bench_launches
    results["bench"] = {"line": line, "wall_s": bench_s}
    for ln in proc.stderr.splitlines():
        if ln.startswith(("timed ", "kernel ", "scan ", "50-step", "dpm++",
                          "10 s clip", "batch-", "serving", "bench done",
                          "sync floor")):
            print(f"bench: {ln}")
    print(f"bench {card}: {json.dumps(line)}")
    print(f"bench: cli bench took {bench_s:.1f} s (wall, its process); "
          f"value x 49 = {traj_ms:.3f} ms against phase 7's "
          f"{times['kernel_a_ms'][1]:.3f} ms; launches {bench_launches}")

    # ---- 9. the tools ----------------------------------------------------
    laps.start("9")
    results["tools"] = tools_phase(work, card, trained, d3, spk,
                                   data_dir / "pairs.csv")
    results["launches"]["tools"] = results["tools"].pop("launches")

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
         "library_ms": None, "etl_b64": results["data_path"]["kernel_c_b64"]},
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
         "bound_by": "operations", "library_ms": e_library_ms,
         "value_b64_per_rank": {"ms": times["kernel_e_ms"]["value_b64"],
                                "plain_ms": times["plain_e_ms"]["value_b64"],
                                "bound_ms": times["bound_e_ms"]["value_b64"]},
         "reference_api_f32_b128": {
             k: results["reference_api"][k] for k in ("ms", "plain_ms",
                                                      "bound_ms")}},
    ]
    by_path = {"normalized_mse": ("normalized_mse_forward",
                                  "normalized_mse_backward"),
               "fused_vggish_distance": ("fused_trunk",)}
    for k in kernels:
        names = by_path.get(k["name"], (k["name"],))
        k["launches_by_path"] = {p: sum(n[x] for x in names)
                                 for p, n in results["launches"].items()}
    laps.start(None)
    results["phase_seconds"] = laps.seconds
    print(f"phase seconds (wall, this run): {laps.seconds}, total "
          f"{sum(laps.seconds.values()):.1f}")
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
