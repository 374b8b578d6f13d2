"""Headline benchmark of the port (library form of ``cli bench``).

Measures on the card every number the JAX package's ``benchmarks.py``
measures, under the same JSON keys, each section through the port's
counterpart of the function the JAX section calls:

* ``value`` (``metric: ddim_step_ms``): the flagship LDM (bf16, seed 0),
  B=1, a 49-step style-conditioned transfer as one launch of kernel A
  (``ops/fused_sampler.py``), per denoising step;
* kernel A on the DPM++ half grid, at B=4 and on a distilled 6-step
  grid; the scan sampler (one UNet call and one kernel B update a step);
  single-call transfer latency (DDIM 50, DPM++ 25); a 10 s clip end to
  end (mel, encode, 50-step DDIM, decode, NNLS and Griffin-Lim); B=64
  transfer throughput with its GFLOP and MFU on four grids; the serving
  engine saturated by 256 queued requests; the B=128 LDM train step
  with the style term's gradient on (kernels E and D) and its GFLOP and
  MFU.

Method.  Each chain feeds each call's output into the next call, as the
JAX package's ``fori_loop`` chains do, and CUDA events on the card
bracket one call of the chain (``timed``): the reported time is the best
of the repeats, the JAX statistic, with the median and spread beside it
on stderr.  The events time the card's queue, so no sync floor is
subtracted (``sync_floor_ms`` records the host round trip of a
one-element read-back).  Before the timed calls run one call that
builds the kernels and picks cuDNN's algorithms and ``WARMUP`` more.
The serving section is timed on the host clock to its last completion,
as in the JAX package.  GFLOP are counted by
``torch.utils.flop_counter.FlopCounterMode`` over one call of the same
function with the VGGish distance on its plain version (kernels A and E
are opaque to the counter; kernel B's elementwise update counts for
nothing on either path), so the count is the work, whatever implements
it.  It counts every tap of a padded convolution and no elementwise
work, where XLA's cost analysis counts only the taps inside the image
and also the elementwise work.

Output: progressive JSON lines on stdout (headline keys first, then the
rest), one after each section; the last holds every key.  A section that
raises ends the run with the fields measured so far printed; SIGTERM or
SIGINT prints them and exits 1.  There is no fallback: on a machine with
no card ``main()`` raises unless the caller passes ``device="cpu"``
(then host clocks and the kernels' plain versions).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import statistics
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_audio
from music_style_transfer_ldm_tpu_torch.audio.mel import (
    db_to_power, melspectrogram, power_to_db,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    db_to_unit_image, unit_image_to_db,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    ddim_sample, transfer_time_grid,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    _denoise_fn, build_ldm, seeded_noise, transfer_decoded,
)
from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
    fused_ddim_update,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_mel_image import (
    fused_mel_unit_image,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
    fused_ddim_sample, pack_operands,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_trunk import fused_trunk
from music_style_transfer_ldm_tpu_torch.ops.normalized_mse import (
    normalized_mse_backward, normalized_mse_forward,
)
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer
from music_style_transfer_ldm_tpu_torch.utils.chips import (
    bench_chain_len, peak_flops_per_sec, resolve_device,
)

# One call builds the kernels and picks cuDNN's plans; WARMUP more calls
# settle the allocator and the clocks before the timed repeats.
WARMUP = 2
STEPS = 50               # the transfer grid: 49 denoising steps
B64 = 64                 # the throughput sections' batch
TRAIN_BATCH = 128        # the reference recipe's batch
SERVING_REQUESTS = 256   # queued at once in the serving section
_BASELINE_MS = 50.0      # BASELINE.md north star: < 50 ms per DDIM step

HEADLINE_KEYS = ("metric", "value", "unit", "vs_baseline")
# (section, the keys it sets), in the order ``main`` runs them.
SECTIONS = (
    ("fused chain", ("value",)),
    ("scan chain", ("scan_step_ms",)),
    ("fused dpm++ chain", ("fused_dpm_halfgrid_transfer_ms",)),
    ("batched fused chain", ("fused_b4_trajectory_ms",)),
    ("fused distilled-grid chain", ("fused_distill6_transfer_ms",)),
    ("client-latency section", ("client_latency_50step_ms",)),
    ("dpm++ section", ("transfer_dpm_halfgrid_ms",)),
    ("end-to-end section", ("e2e_10s_clip_s",)),
    ("batch-64 section",
     ("transfer_b64_ms", "transfer_b64_gflop", "mfu_transfer_b64")),
    ("batch-64 dpm++ section", ("transfer_b64_dpm25_clips_per_s",)),
    ("batch-64 distilled section", ("transfer_b64_distill6_clips_per_s",)),
    ("batch-64 distill-1 section", ("transfer_b64_distill1_clips_per_s",)),
    ("serving section", ("serving_saturated_clips_per_s",)),
    ("train-step section",
     ("train_b128_step_ms", "train_b128_gflop", "mfu_train_b128")),
)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak_flops_per_sec(device) -> float | None:
    """Peak dense bf16 FLOP/s of the card (``utils/chips.py``), or None
    for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return peak_flops_per_sec(torch.cuda.get_device_name(device))


def _flops(fn, *args) -> float | None:
    """FLOPs of one call ``fn(*args)`` (it runs, side effects included),
    counted by ``FlopCounterMode``: matrix products and convolutions at 2
    per multiply-add; None if it counted nothing."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    total = float(counter.get_total_flops())
    return total if total > 0 else None


def _mfu(flops: float | None, seconds: float, peak: float | None
         ) -> float | None:
    if flops is None or peak is None or seconds <= 0:
        return None
    return flops / seconds / peak


def timed(fn, *args, repeats: int = 8, warmup: int = WARMUP,
          device="cuda"):
    """(best seconds of ``repeats`` calls of ``fn(*args)``, the last
    output), after one untimed call and ``warmup`` more.  On the card
    each call is bracketed by CUDA events on ``device``'s current stream
    and the card is synchronised after it; on the CPU the host clock
    times it.  The median and spread go to stderr."""
    device = torch.device(device)
    out = fn(*args)
    for _ in range(warmup):
        out = fn(*args)
    _sync(device)
    seconds = []
    for _ in range(repeats):
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args)
            end.record(stream)
            end.synchronize()
            seconds.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            seconds.append(time.perf_counter() - t0)
    _sync(device)
    best = min(seconds)
    log(f"timed {getattr(fn, '__name__', 'call')}: best {best * 1e3:.3f} "
        f"ms, median {statistics.median(seconds) * 1e3:.3f} ms, spread "
        f"{(max(seconds) - best) * 1e3:.3f} ms over {repeats} calls")
    return best, out


class Emitter:
    """Progressive headline JSON: re-printed after every section that
    lands a number (a reader takes the last line), and once more from the
    SIGTERM/SIGINT handler.  Every field is measured in this run."""

    # The sections' keys besides the headline's, as the JAX package's.
    _SECONDARY_KEYS = tuple(k for _, keys in SECTIONS for k in keys
                            if k not in HEADLINE_KEYS)

    def __init__(self) -> None:
        self.fields: dict = {}

    def ready(self) -> bool:
        return "value" in self.fields

    def set(self, **kv) -> None:
        for k, v in kv.items():
            if v is not None:
                self.fields[k] = v

    def set_headline(self, step_ms: float, source: str) -> None:
        self.fields["metric"] = "ddim_step_ms"
        self.fields["value"] = round(step_ms, 4)
        self.fields["unit"] = "ms"
        self.fields["vs_baseline"] = round(_BASELINE_MS / step_ms, 2)
        self.fields["sampler"] = source

    def emit(self) -> None:
        if not self.ready():
            return
        ordered = {k: self.fields[k] for k in HEADLINE_KEYS
                   if k in self.fields}
        ordered.update({k: v for k, v in self.fields.items()
                        if k not in HEADLINE_KEYS})
        print(json.dumps(ordered), flush=True)

    def install_kill_handler(self) -> None:
        """On SIGTERM or SIGINT: print the fields measured so far and exit
        1 (the run did not finish)."""
        def handler(signum, frame):  # noqa: ARG001
            log(f"signal {signum}: printing the fields measured so far")
            self.emit()
            sys.stdout.flush()
            os._exit(1)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)


# ---- the chains: each call's output is the next call's input ------------

def fused_chain(ldm, emb, times, z, n_chain: int, sampler: str = "ddim"):
    """Pack kernel A's operands for ``times`` (as the JAX chain packs
    inside its program), then run ``n_chain`` trajectories of z [B, 16,
    16, 32] NHWC, each from the previous one's output."""
    ops = pack_operands(ldm.unet, emb, ldm.schedule, times, 0.0,
                        sampler=sampler, batch=z.shape[0])
    for _ in range(n_chain):
        z = fused_ddim_sample(ops, z, len(times) - 1)
    return z


def transfer_chain(ldm, content, style, n_chain: int, **kw):
    """``n_chain`` transfers, each call's decoded output the next one's
    content and the style batch rolled by one row per call (as in the
    JAX package, whose compiler would otherwise hoist the style
    encoder)."""
    for i in range(n_chain):
        content = transfer_decoded(ldm, content, torch.roll(style, i, 0),
                                   num_timesteps=STEPS, eta=0.0, seeds=2,
                                   **kw)[0]
    return content


def _launch_counts() -> dict:
    """Each kernel wrapper's launch count: A, B, C, D (forward and
    backward), E."""
    return {f.__name__: f.launches for f in (
        fused_ddim_sample, fused_ddim_update, fused_mel_unit_image,
        normalized_mse_forward, normalized_mse_backward, fused_trunk)}


def main(device="cuda") -> None:
    """Run every section on ``device`` (the card unless the caller asks
    for the CPU) and print the JSON lines; raises on the first section
    that fails, after printing the fields measured so far."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    emitter = Emitter()
    emitter.install_kill_handler()
    t_bench = time.time()
    launches0 = _launch_counts()

    cfg = default_config()
    S, lat, ch = (cfg.model.image_size, cfg.model.image_size // 8,
                  cfg.model.latent_dim)
    t0 = time.time()
    ldm = build_ldm(cfg, dtype=torch.bfloat16, device=dev, seed=0)

    def unit(seed, *shape):
        return torch.as_tensor(np.random.RandomState(seed).rand(*shape)
                               .astype(np.float32), device=dev)

    content, style = unit(0, 1, S, S, 1), unit(1, 1, S, S, 1)
    _sync(dev)
    log(f"device {dev}: param init {time.time() - t0:.1f} s")

    n_steps = STEPS - 1
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    n_chain = bench_chain_len(kind) if on_card else 2
    n_b64, n_train = (8, 4) if on_card else (1, 1)
    peak = _peak_flops_per_sec(dev)
    if on_card and peak is None:
        raise RuntimeError(
            f"{kind}: no peak FLOP/s in utils/chips.py's table, so no MFU; "
            "add the card's published peak there")
    emitter.set(
        chip=kind, chip_peak_tflops=(round(peak / 1e12) if peak else None),
        methodology=(
            ("CUDA events around one call of N chained calls on the card, "
             if on_card else "host clock around one call of N chained "
             "calls on the CPU, ")
            + f"best of the repeats after {1 + WARMUP} untimed calls; no "
            "sync floor subtracted; GFLOP counted by torch's "
            "FlopCounterMode with the VGGish distance on its plain version: "
            "every tap of a padded conv, no elementwise work, so 1.090x "
            "XLA's cost analysis for the denoiser and 1.035x for the train "
            "step (B=2, full width), and the MFUs read that much above the "
            "JAX package's"))

    floor = []
    for _ in range(10):
        t0 = time.perf_counter()
        content.reshape(-1)[0].item()
        floor.append(time.perf_counter() - t0)
    log(f"sync floor (one-element read-back): {min(floor) * 1e3:.3f} ms")
    emitter.set(sync_floor_ms=round(min(floor) * 1e3, 3))

    grid = transfer_time_grid(STEPS)
    with torch.no_grad():
        emb = ldm.style_embed(style)
        emb_nchw = ldm.style_encoder(style.permute(0, 3, 1, 2)
                                     .to(ldm.dtype))
    z0 = seeded_noise((1, lat, lat, ch), 4, dev)
    step_ms = None

    def sec_fused():
        nonlocal step_ms

        def chain_fused(z):
            return fused_chain(ldm, emb, grid, z, n_chain)

        fused_s, _ = timed(chain_fused, z0, device=dev)
        step_ms = fused_s / n_chain / n_steps * 1e3
        log(f"kernel A trajectory x{n_chain} chained: {fused_s * 1e3:.1f} ms"
            f" -> {step_ms:.4f} ms/step")
        emitter.set_headline(step_ms, "kernel A: the whole trajectory in "
                                      "one launch (csrc/fused_sampler.cu)")

    def sec_scan():
        # the scan route is host-bound at 75-120 ms a B=1 trajectory on
        # an H100 80GB HBM3 at 700 W (chip_smoke.py phase 7): a sixteenth
        # of kernel A's chain keeps its window above 100 ms
        n_scan = max(1, n_chain // 16)

        fn = _denoise_fn(ldm, emb_nchw, f32=False)

        def chain_scan(z):      # the UNet and one kernel B update a step
            for _ in range(n_scan):
                z = ddim_sample(fn, ldm.schedule, z, grid, eta=0.0)
            return z

        scan_s, _ = timed(chain_scan, z0.permute(0, 3, 1, 2), device=dev)
        scan_step_ms = scan_s / n_scan / n_steps * 1e3
        log(f"scan sampler x{n_scan} chained: {scan_s * 1e3:.1f} ms -> "
            f"{scan_step_ms:.4f} ms/step (kernel A "
            f"{scan_step_ms / step_ms:.2f}x faster)")
        emitter.set(scan_step_ms=round(scan_step_ms, 4))

    def sec_fused_dpm():
        dpm_grid = transfer_time_grid(STEPS, STEPS // 2)
        n_dpm = 2 * n_chain      # half the steps: twice the chain

        def chain_fused_dpm(z):
            return fused_chain(ldm, emb, dpm_grid, z, n_dpm, "dpm++")

        fd_s, _ = timed(chain_fused_dpm, z0, device=dev)
        ms = fd_s / n_dpm * 1e3
        log(f"kernel A dpm++ {len(dpm_grid) - 1}-step trajectory x{n_dpm} "
            f"chained: {ms:.3f} ms per transfer")
        emitter.set(fused_dpm_halfgrid_transfer_ms=round(ms, 3))

    def sec_fused_b4():
        bsz = 4
        zb = seeded_noise((bsz, lat, lat, ch), 5, dev)

        def chain_fused_batch(z):
            return fused_chain(ldm, emb, grid, z, n_chain)

        fb_s, _ = timed(chain_fused_batch, zb, device=dev)
        ms = fb_s / n_chain * 1e3
        log(f"kernel A batch-{bsz} trajectory x{n_chain} chained: {ms:.3f} "
            f"ms per batch trajectory ({bsz * 1e3 / ms:.0f} clips/s)")
        emitter.set(fused_b4_trajectory_ms=round(ms, 3))

    def sec_fused_d6():
        d6_grid = transfer_time_grid(STEPS, 7)
        n_d6 = 8 * n_chain       # 6 of 49 steps: eight times the chain

        def chain_fused_d6(z):
            return fused_chain(ldm, emb, d6_grid, z, n_d6)

        f6_s, _ = timed(chain_fused_d6, z0, device=dev)
        ms = f6_s / n_d6 * 1e3
        log(f"kernel A distilled 6-step trajectory x{n_d6} chained: "
            f"{ms:.4f} ms per transfer ({1e3 / ms:.0f} clips/s at B=1)")
        emitter.set(fused_distill6_transfer_ms=round(ms, 4))

    def transfer(c, s):
        return transfer_decoded(ldm, c, s, num_timesteps=STEPS, eta=0.0,
                                seeds=2)[0]

    def sec_client_latency():
        total_s, _ = timed(transfer, content, style, device=dev)
        log(f"50-step transfer, one call: {total_s * 1e3:.1f} ms")
        emitter.set(client_latency_50step_ms=round(total_s * 1e3, 2))

    def sec_dpm_scan():
        def transfer_dpm(c, s):
            return transfer_decoded(ldm, c, s, num_timesteps=STEPS, eta=0.0,
                                    sampler="dpm++", steps=STEPS // 2,
                                    seeds=2)[0]

        dpm_s, _ = timed(transfer_dpm, content, style, device=dev)
        log(f"dpm++ {STEPS // 2}-step transfer, one call: "
            f"{dpm_s * 1e3:.1f} ms")
        emitter.set(transfer_dpm_halfgrid_ms=round(dpm_s * 1e3, 2))

    def sec_e2e():
        sr = cfg.audio.sample_rate
        clip = torch.as_tensor(np.random.RandomState(2).randn(4, 3 * sr)
                               .astype(np.float32) * 0.1, device=dev)
        style4 = style.repeat(4, 1, 1, 1)

        def end_to_end(chunks, style_img):
            mel_power = melspectrogram(chunks, sr=sr, n_mels=128)
            db = power_to_db(mel_power, batched=True)
            imgs = db_to_unit_image(db)[:, :, :128, None]
            decoded = transfer_decoded(ldm, imgs, style_img,
                                       num_timesteps=STEPS, eta=0.0,
                                       seeds=3)[0]
            out_db = unit_image_to_db(decoded[:, :, :, 0])
            # back to 130 frames with silence columns for the inversion
            out_db = F.pad(out_db, (0, 2), value=-80.0)
            return mel_to_audio(db_to_power(out_db), sr=sr, n_iter=32,
                                nnls_iters=64, length=3 * sr)

        e2e_s, audio = timed(end_to_end, clip, style4, repeats=3, warmup=1,
                             device=dev)
        log(f"10 s clip end to end (mel, encode, 50-step DDIM, decode, "
            f"NNLS + Griffin-Lim): {e2e_s:.3f} s; audio "
            f"{tuple(audio.shape)}")
        emitter.set(e2e_10s_clip_s=round(e2e_s, 3))

    content64 = content.repeat(B64, 1, 1, 1)
    style64 = style.repeat(B64, 1, 1, 1)

    def b64_seconds(**kw) -> float:
        def chain_b64(c):
            return transfer_chain(ldm, c, style64, n_b64, **kw)

        s, _ = timed(chain_b64, content64, repeats=3, warmup=1, device=dev)
        return s / n_b64

    def sec_b64():
        thr_s = b64_seconds()
        flops = _flops(transfer, content64, style64)
        mfu = _mfu(flops, thr_s, peak)
        log(f"batch-{B64} transfer (x{n_b64} chained): "
            f"{B64 / thr_s:.0f} clips/s ({thr_s * 1e3:.1f} ms/batch), "
            f"{(flops or 0) / 1e9:.1f} GFLOP"
            + (f", MFU {mfu:.2%}" if mfu is not None else ""))
        emitter.set(
            transfer_b64_ms=round(thr_s * 1e3, 2),
            transfer_b64_gflop=round(flops / 1e9, 2) if flops else None,
            mfu_transfer_b64=round(mfu, 4) if mfu is not None else None)

    def sec_b64_dpm():
        thr = b64_seconds(sampler="dpm++", steps=STEPS // 2)
        log(f"batch-{B64} dpm++ {STEPS // 2}-step transfer: "
            f"{B64 / thr:.0f} clips/s ({thr * 1e3:.1f} ms/batch)")
        emitter.set(transfer_b64_dpm25_clips_per_s=round(B64 / thr))

    def sec_b64_d6():
        thr = b64_seconds(steps=7)
        log(f"batch-{B64} distilled-grid 6-step transfer: "
            f"{B64 / thr:.0f} clips/s ({thr * 1e3:.2f} ms/batch)")
        emitter.set(transfer_b64_distill6_clips_per_s=round(B64 / thr))

    def sec_b64_d1():
        thr = b64_seconds(steps=2)
        log(f"batch-{B64} distilled-grid 1-step transfer: "
            f"{B64 / thr:.0f} clips/s ({thr * 1e3:.2f} ms/batch)")
        emitter.set(transfer_b64_distill1_clips_per_s=round(B64 / thr))

    def sec_serving():
        ecfg = EngineConfig(sampler="dpm++", sample_steps=STEPS // 2 + 1,
                            invert_audio=False)
        engine = InferenceEngine(ldm, ecfg)
        engine.warmup()
        engine.start()
        try:
            rng_s = np.random.RandomState(3)
            reqs = [(rng_s.rand(S, S, 1).astype(np.float32),
                     rng_s.rand(S, S, 1).astype(np.float32))
                    for _ in range(16)]
            engine.submit(*reqs[0], seed=0).get(timeout=120)   # primer
            t0 = time.perf_counter()
            waiters = [engine.submit(*reqs[i % 16], seed=i)
                       for i in range(SERVING_REQUESTS)]
            for w in waiters:
                out = w.get(timeout=120)
                if isinstance(out, Exception):
                    raise out
            dt = time.perf_counter() - t0
        finally:
            engine.stop()
        log(f"serving saturation: {SERVING_REQUESTS} queued requests in "
            f"{dt:.2f} s -> {SERVING_REQUESTS / dt:.0f} clips/s (dpm++ "
            f"{STEPS // 2 + 1}-point grid, buckets {ecfg.batch_buckets})")
        emitter.set(serving_saturated_clips_per_s=round(
            SERVING_REQUESTS / dt, 1))

    def sec_train():
        # The flagship recipe's trainable style term: with its gradient the
        # style branch (kernel E with its pred gradient, kernel D's
        # backward) is part of every step, as in the JAX package's section.
        bench_cfg = dataclasses.replace(cfg)
        bench_cfg.train = dataclasses.replace(
            cfg.train, style_loss_stop_gradient=False)
        c128 = content.repeat(TRAIN_BATCH, 1, 1, 1)
        s128 = style.repeat(TRAIN_BATCH, 1, 1, 1)
        plain = LDMTrainer(bench_cfg, device=dev, feature_impl="plain")
        train_flops = _flops(plain._step, plain.init_state(0), c128, s128)
        del plain
        trainer = LDMTrainer(bench_cfg, device=dev)
        state = trainer.init_state(0)

        def chain_train(st):
            # each step from the previous one's state, the batches rolled
            # by one row per step (as in the JAX package)
            for i in range(n_train):
                st = trainer._step(st, torch.roll(c128, i, 0),
                                   torch.roll(s128, i, 0))[0]
            return st

        e0, d0 = fused_trunk.launches, normalized_mse_backward.launches
        tr_s, _ = timed(chain_train, state, repeats=4, warmup=1, device=dev)
        e, d_bwd = (fused_trunk.launches - e0,
                    normalized_mse_backward.launches - d0)
        if on_card and not 0 < 6 * e <= d_bwd:
            raise RuntimeError(
                f"the train steps launched kernel E {e} times and kernel "
                f"D's backward {d_bwd}: E did not run with its gradient")
        train_s = tr_s / n_train
        mfu = _mfu(train_flops, train_s, peak)
        log(f"batch-{TRAIN_BATCH} train step (x{n_train} chained): "
            f"{train_s * 1e3:.1f} ms, {(train_flops or 0) / 1e9:.1f} GFLOP"
            + (f", MFU {mfu:.2%}" if mfu is not None else "")
            + f" ({TRAIN_BATCH / train_s:.0f} samples/s; kernel E {e} "
            f"launches with its gradient, D backward {d_bwd})")
        emitter.set(
            train_b128_step_ms=round(train_s * 1e3, 2),
            train_b128_gflop=(round(train_flops / 1e9, 2)
                              if train_flops else None),
            mfu_train_b128=round(mfu, 4) if mfu is not None else None)

    run = dict(zip((name for name, _ in SECTIONS), (
        sec_fused, sec_scan, sec_fused_dpm, sec_fused_b4, sec_fused_d6,
        sec_client_latency, sec_dpm_scan, sec_e2e, sec_b64, sec_b64_dpm,
        sec_b64_d6, sec_b64_d1, sec_serving, sec_train)))
    for name, keys in SECTIONS:
        try:
            run[name]()
            # an MFU needs the card's peak: on the CPU there is none
            missing = [k for k in keys if k not in emitter.fields
                       and (on_card or not k.startswith("mfu_"))]
            if missing:
                raise RuntimeError(f"{name} measured no {missing}")
        except Exception:
            log(f"{name} failed; the fields measured so far follow")
            emitter.emit()
            raise
        emitter.emit()
    _sync(dev)
    now = _launch_counts()
    log("kernel launches: " + json.dumps(
        {k: now[k] - launches0[k] for k in now}))
    log(f"bench done in {time.time() - t_bench:.0f} s")


if __name__ == "__main__":
    main()
