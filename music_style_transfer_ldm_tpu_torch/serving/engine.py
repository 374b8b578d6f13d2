"""Inference engine with request microbatching, on the GPU.

* The LDM lives on the device once; requests are padded to a fixed
  ladder of batch buckets (1, 2, 4, 8), and ``warmup`` runs every bucket
  once before traffic (kernel builds and JIT happen there).
* Buckets up to ``fused_bucket_max`` take the fused trajectory kernel
  (sampler 'fused' or 'fused-dpm++'); larger buckets take the scan
  sampler, whose DDIM step is the update kernel B
  (``ops/ddim_update.py``).
* Each request's noise comes from a generator seeded by its own seed, so
  its result does not depend on how requests were grouped; the programs
  run on cuDNN's deterministic algorithms (``utils/chips.py
  deterministic_convs``, scoped to them), so the same request gives the
  same bits again.
* ``_finish_outputs`` inverts the decoded images to audio on the device:
  dB -> power -> NNLS -> Griffin-Lim.
* ``ap`` is the engine's AudioProcessor, on its device: WAV requests
  become images there through kernel C (``ops/fused_mel_image.py``).
* ``generate`` is generation from noise (the scan DDIM, so kernel B),
  synchronous behind a lock that it waits for at most ``timeout`` s; its
  calls and waiters show in ``stats()``, and waiters count as pending
  load.
* ``stats()`` (served at ``/stats``) counts requests, dispatches (also by
  bucket), rows, padded slots, and the requests taken from the queue
  with the seconds they waited there; with a tracer on
  (``utils/profiling.py``) each request's queue wait and each dispatch's
  upload, read-back and reply are spans too.
* With ``autoscale``, a 2x bucket is warmed on a side thread once the
  largest bucket keeps saturating while requests still queue.
* With a ``mesh`` (``parallel/make_mesh`` over a list of devices; one
  may repeat) there is one model replica per mesh device, the buckets
  round up to multiples of the data axis, and each bucket's rows split
  into contiguous blocks: every replica runs its block's whole transfer
  program (encode, the scan sampler with kernel B, decode, NNLS,
  Griffin-Lim), each on its own CUDA stream, all issued before any
  result is read back, and the rows are reassembled in order.  The fused
  route is bypassed (``uses_fused``), as in the JAX package.  A row's
  result does not depend on its replica: its noise comes from its own
  seed and Griffin-Lim's seeded phase field is the same everywhere.
  Generation runs on the first replica.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_audio
from music_style_transfer_ldm_tpu_torch.audio.mel import db_to_power
from music_style_transfer_ldm_tpu_torch.audio.processor import (
    AudioProcessor,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    unit_image_to_db,
)
from music_style_transfer_ldm_tpu_torch.config import AudioConfig
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    match_moments, style_ddim_sample, transfer_decoded,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
    fused_content_style_transfer,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import (
    deterministic_convs, fused_bucket_max,
)
from music_style_transfer_ldm_tpu_torch.utils.profiling import (
    record, span,
)

SAMPLERS = ("ddim", "dpm++", "fused", "fused-dpm++")


@dataclasses.dataclass
class EngineConfig:
    steps: int = 50
    eta: float = 0.0
    # 'ddim', 'dpm++' (DPM-Solver++(2M); with sample_steps < steps a
    # coarse grid), 'fused' or 'fused-dpm++' (the whole-trajectory kernel
    # on buckets <= fused_bucket_max, the scan sampler with the same
    # update rule above).
    sampler: str = "ddim"
    sample_steps: Optional[int] = None
    # Classifier-free style guidance; != 1 needs a scan sampler.
    guidance: float = 1.0
    # Largest bucket routed to the fused kernel; None = utils.chips.
    fused_bucket_max: Optional[int] = None
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    max_wait_ms: float = 5.0
    image_size: int = 128
    match_level: bool = False
    griffin_lim_iters: int = 32
    nnls_iters: int = 64
    invert_audio: bool = True
    # Bucket autoscaling: after ``autoscale_after`` consecutive dispatches
    # that fill the largest warm bucket while requests still queue, a 2x
    # bucket is warmed on a side thread and adopted, up to max_bucket.
    autoscale: bool = False
    autoscale_after: int = 4
    max_bucket: int = 128
    # Generation from noise (POST /v1/generate): its own grid and
    # guidance.  generate_steps None = reuse ``steps``.
    generate_steps: Optional[int] = None
    generate_guidance: float = 1.0


class InferenceEngine:
    """Warm engine over an LDM (``models.ldm.build_ldm`` or one filled by
    ``interop.flax_weights.load_flax_variables``); ``mesh`` spreads every
    bucket over one replica per mesh device."""

    def __init__(self, ldm, config: Optional[EngineConfig] = None,
                 audio: Optional[AudioConfig] = None, mesh=None):
        self.mesh = mesh
        self.config = config or EngineConfig()
        self.replicas = [ldm]
        if mesh is not None:
            if mesh.distributed:
                raise ValueError("the engine's mesh lists devices in one "
                                 "process (make_mesh(devices=...))")
            self.replicas = [
                ldm if i == 0 and dev == ldm.device
                else copy.deepcopy(ldm).to(dev)
                for i, dev in enumerate(mesh.devices)]
            n = mesh.size
            self.config = dataclasses.replace(
                self.config, batch_buckets=tuple(sorted({
                    -(-b // n) * n for b in self.config.batch_buckets})))
        self.ldm = self.replicas[0]
        if self.config.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.config.sampler!r}")
        if (self.config.guidance != 1.0
                and self.config.sampler in ("fused", "fused-dpm++")):
            raise ValueError(
                "guidance != 1 needs a scan sampler (ddim/dpm++); the "
                "fused trajectory kernel runs the conditional branch only")
        self.fused_bucket_max = (self.config.fused_bucket_max
                                 if self.config.fused_bucket_max is not None
                                 else fused_bucket_max())
        self.audio = audio or AudioConfig()
        self.device = self.ldm.device
        self._streams = [torch.cuda.Stream(r.device)
                         if r.device.type == "cuda" else None
                         for r in self.replicas]
        self.ap = AudioProcessor(self.audio.sample_rate, self.audio.n_fft,
                                 self.audio.hop_length,
                                 nnls_iters=self.config.nnls_iters,
                                 device=self.device)
        self._queue: queue.Queue = queue.Queue()
        self._stats = {"requests": 0, "batches": 0, "padded_slots": 0,
                       "autoscaled_buckets": 0, "generate_calls": 0,
                       "generate_waiting": 0, "dispatches_by_bucket": {},
                       "rows_dispatched": 0, "queue_waits": 0,
                       "queue_wait_s_total": 0.0}
        self._request_ids = itertools.count()
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._warm_buckets: frozenset = frozenset()
        self._warming: set = set()
        self._saturated = 0
        self._gen_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # ---------------- the transfer program -----------------------------

    def uses_fused(self, bucket: int) -> bool:
        """Whether a bucket of this size takes the fused kernel (never
        under a mesh)."""
        return (self.mesh is None
                and self.config.sampler in ("fused", "fused-dpm++")
                and bucket <= self.fused_bucket_max)

    @torch.no_grad()
    @deterministic_convs()
    def _transfer(self, content: torch.Tensor, style: torch.Tensor,
                  seeds: np.ndarray) -> dict:
        """The transfer program on a bucket: on the one model, or split
        over the replicas (each block on its replica's stream, all issued
        before the first read back) and reassembled on the host."""
        if self.mesh is None:
            return self._transfer_on(self.ldm, content, style, seeds)
        n = len(self.replicas)
        per = content.shape[0] // n
        current = (torch.cuda.current_stream(self.device)
                   if self.device.type == "cuda" else None)
        outs = []
        for i, (ldm, stream) in enumerate(zip(self.replicas, self._streams)):
            rows = slice(i * per, (i + 1) * per)
            ctx = contextlib.nullcontext()
            if stream is not None:
                if current is not None:
                    stream.wait_stream(current)
                ctx = torch.cuda.stream(stream)
            with ctx:
                outs.append(self._transfer_on(
                    ldm, content[rows].to(ldm.device, non_blocking=True),
                    style[rows].to(ldm.device, non_blocking=True),
                    seeds[rows]))
        for stream in self._streams:
            if stream is not None:
                stream.synchronize()
        return {k: torch.cat([o[k].cpu() for o in outs]) for k in outs[0]}

    def _transfer_on(self, ldm, content: torch.Tensor, style: torch.Tensor,
                     seeds: np.ndarray) -> dict:
        cfg = self.config
        fused = cfg.sampler in ("fused", "fused-dpm++")
        # 'fused-dpm++' keeps the second-order update on both routes.
        inner = "dpm++" if cfg.sampler == "fused-dpm++" else (
            "ddim" if fused else cfg.sampler)
        if self.uses_fused(content.shape[0]):
            decoded = fused_content_style_transfer(
                ldm, content, style, num_timesteps=cfg.steps,
                eta=cfg.eta, sampler=inner, steps=cfg.sample_steps,
                seeds=seeds)
        else:
            decoded, _ = transfer_decoded(
                ldm, content, style, num_timesteps=cfg.steps,
                eta=cfg.eta, sampler=inner, steps=cfg.sample_steps,
                guidance=cfg.guidance, seeds=seeds)
        if cfg.match_level:
            decoded = match_moments(decoded, style)
        return self._finish_outputs(decoded)

    def _finish_outputs(self, decoded: torch.Tensor) -> dict:
        """{'image': [B, S, S, 1]} plus, with invert_audio, 'audio'
        [B, 3 * sr] from NNLS + Griffin-Lim on the device."""
        cfg, a = self.config, self.audio
        out = {"image": decoded}
        if cfg.invert_audio:
            db = unit_image_to_db(decoded[:, :, :, 0])
            out["audio"] = mel_to_audio(
                db_to_power(db), sr=a.sample_rate, n_fft=a.n_fft,
                hop_length=a.hop_length, n_iter=cfg.griffin_lim_iters,
                nnls_iters=cfg.nnls_iters, length=int(3 * a.sample_rate))
        return out

    @torch.no_grad()
    @deterministic_convs()
    def _generate(self, style: torch.Tensor, seed: int) -> dict:
        cfg = self.config
        sampler = ("ddim" if cfg.sampler in ("fused", "fused-dpm++")
                   else cfg.sampler)
        lat = cfg.image_size // 8
        decoded = style_ddim_sample(
            self.ldm, (style.shape[0], lat, lat, self.ldm.latent_dim),
            style, timesteps=(cfg.generate_steps
                              if cfg.generate_steps is not None
                              else cfg.steps),
            eta=cfg.eta, sampler=sampler, guidance=cfg.generate_guidance,
            seed=seed)
        if cfg.match_level:
            decoded = match_moments(decoded, style)
        return self._finish_outputs(decoded)

    def warmup(self) -> None:
        """Run every route once before traffic, so every kernel is built
        here and a build error surfaces before a server listens: each
        transfer bucket, the WAV front end, and the generate route."""
        S = self.config.image_size
        for b in self.config.batch_buckets:
            x = torch.zeros((b, S, S, 1), device=self.device)
            self._transfer(x, x, np.zeros((b,), np.int64))
            self._warm_buckets = self._warm_buckets | {b}
        self.ap.waveform_batch_to_unit_images(
            np.zeros((1, int(3 * self.audio.sample_rate)), np.float32))
        self._generate(torch.zeros((1, S, S, 1), device=self.device), 0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- synchronous API -----------------------------------

    def transfer_batch(self, content: np.ndarray, style: np.ndarray,
                       seeds=0) -> dict:
        """[B, 128, 128, 1] content + style -> {'image', 'audio'} numpy.

        seeds: one for all items, or one per item.  Batches larger than
        the biggest bucket are split; smaller ones are padded with
        repeats of the last item to the next bucket and cropped back."""
        if not self._warm_buckets:
            self.warmup()
        warm = self._warm_buckets
        b = content.shape[0]
        seeds = np.broadcast_to(np.asarray(seeds, np.int64), (b,))
        max_bucket = max(warm)
        if b > max_bucket:
            parts = [self.transfer_batch(content[s:s + max_bucket],
                                         style[s:s + max_bucket],
                                         seeds[s:s + max_bucket])
                     for s in range(0, b, max_bucket)]
            return {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        bucket = self._bucket(b)
        pad = bucket - b
        if pad:
            content = np.concatenate(
                [content, np.repeat(content[-1:], pad, axis=0)])
            style = np.concatenate(
                [style, np.repeat(style[-1:], pad, axis=0)])
            seeds = np.concatenate([seeds, np.repeat(seeds[-1:], pad)])
        with span("engine.upload"):
            content = torch.as_tensor(np.asarray(content, np.float32),
                                      device=self.device)
            style = torch.as_tensor(np.asarray(style, np.float32),
                                    device=self.device)
        out = self._transfer(content, style, seeds)
        with span("engine.readback"):
            out = {k: v[:b].cpu().numpy() for k, v in out.items()}
        with self._stats_lock:
            st = self._stats
            st["padded_slots"] += pad
            st["batches"] += 1
            st["dispatches_by_bucket"][bucket] = (
                st["dispatches_by_bucket"].get(bucket, 0) + 1)
            st["rows_dispatched"] += b
        return out

    def _bucket(self, rows: int) -> int:
        """The smallest warm bucket that holds ``rows``."""
        return min(k for k in self._warm_buckets if k >= rows)

    def generate(self, style: np.ndarray, seed: int = 0,
                 timeout: Optional[float] = None) -> dict:
        """[B, S, S, 1] style images -> generation from noise:
        {'image' [B, S, S, 1], 'audio' [B, T]?} as numpy.

        Synchronous and serialised behind a lock; waits for it at most
        ``timeout`` seconds (None = forever), then raises TimeoutError.
        Deterministic in (seed, batch size)."""
        with self._stats_lock:
            self._stats["generate_waiting"] += 1
        try:
            got = self._gen_lock.acquire(
                timeout=-1 if timeout is None else max(timeout, 0.0))
        finally:
            with self._stats_lock:
                self._stats["generate_waiting"] -= 1
        if not got:
            raise TimeoutError(f"generate lock not free within {timeout} s")
        try:
            with self._stats_lock:
                self._stats["generate_calls"] += 1
            out = self._generate(
                torch.as_tensor(np.asarray(style, np.float32),
                                device=self.device), seed)
            return {k: v.cpu().numpy() for k, v in out.items()}
        finally:
            self._gen_lock.release()

    # ---------------- async microbatching API ---------------------------

    def start(self) -> None:
        if self._thread is None:
            if not self._warm_buckets:
                self.warmup()
            self._stop.clear()
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def submit(self, content: np.ndarray, style: np.ndarray,
               seed: int = 0) -> "queue.Queue":
        """Enqueue one request ([128, 128, 1] images); returns a queue
        that receives the {'image', 'audio'} dict (or an exception)."""
        done: queue.Queue = queue.Queue(maxsize=1)
        self._queue.put((content, style, seed, done, time.perf_counter(),
                         next(self._request_ids)))
        with self._stats_lock:
            self._stats["requests"] += 1
        return done

    def _maybe_autoscale(self, batch_len: int, max_b: int) -> None:
        """Warm a 2x bucket on a side thread when demand keeps filling the
        largest warm bucket (traffic continues on the warm buckets)."""
        if not self.config.autoscale:
            return
        if batch_len >= max_b and self.pending() > 0:
            self._saturated += 1
        else:
            self._saturated = 0
        new_b = max_b * 2
        if (self._saturated < self.config.autoscale_after
                or new_b > self.config.max_bucket):
            return
        with self._stats_lock:
            if new_b in self._warming or new_b in self._warm_buckets:
                return
            self._warming.add(new_b)
        self._saturated = 0

        def work():
            S = self.config.image_size
            x = torch.zeros((new_b, S, S, 1), device=self.device)
            self._transfer(x, x, np.zeros((new_b,), np.int64))
            with self._stats_lock:
                # Rebind, never mutate: the dispatcher reads it unlocked.
                self._warm_buckets = self._warm_buckets | {new_b}
                self._warming.discard(new_b)
                self._stats["autoscaled_buckets"] += 1

        threading.Thread(target=work, daemon=True).start()

    def _take(self, timeout: float):
        """The next queued request; its wait ends here."""
        item = self._queue.get(timeout=timeout)
        now = time.perf_counter()
        record("engine.queue_wait", item[4], now, trace_id=item[5])
        return item, now - item[4]

    def _dispatch_loop(self) -> None:
        wait_s = self.config.max_wait_ms / 1000.0
        while not self._stop.is_set():
            max_b = max(self._warm_buckets)
            try:
                first, waited = self._take(0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + wait_s
            while len(batch) < max_b:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item, w = self._take(remaining)
                except queue.Empty:
                    break
                batch.append(item)
                waited += w
            with self._stats_lock:
                self._stats["queue_waits"] += len(batch)
                self._stats["queue_wait_s_total"] += waited
            self._maybe_autoscale(len(batch), max_b)
            bucket = self._bucket(len(batch))
            with span("engine.batch", rows=len(batch), bucket=bucket,
                      route="fused" if self.uses_fused(bucket) else "scan"):
                try:
                    content = np.stack([r[0] for r in batch])
                    style = np.stack([r[1] for r in batch])
                    seeds = np.asarray([r[2] for r in batch], np.int64)
                    out = self.transfer_batch(content, style, seeds=seeds)
                    with span("engine.reply"):
                        for i, r in enumerate(batch):
                            r[3].put({k: v[i] for k, v in out.items()})
                except Exception as e:  # noqa: BLE001 — deliver, don't die
                    for r in batch:
                        r[3].put(e)
        # Fail anything still queued so no waiter hangs after stop().
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            item[3].put(RuntimeError("engine stopped"))

    def pending(self) -> int:
        """Requests queued but not yet dispatched, plus generate calls
        waiting for the lock (the load-shedding signal)."""
        return self._queue.qsize() + self._stats["generate_waiting"]

    def stats(self) -> dict:
        with self._stats_lock:
            stats = dict(self._stats)
            stats["dispatches_by_bucket"] = dict(
                stats["dispatches_by_bucket"])
        return {**stats, "pending": self.pending()}
