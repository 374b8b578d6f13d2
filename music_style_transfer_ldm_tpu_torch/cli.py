"""Command-line interface of the port.

  python -m music_style_transfer_ldm_tpu_torch.cli download --csv urls.csv
  python -m music_style_transfer_ldm_tpu_torch.cli build-dataset \\
      --audio-dir downloads --output-root processed_images
  python -m music_style_transfer_ldm_tpu_torch.cli transfer \\
      --checkpoint ckpt.pt --content c.wav --style s.png
  python -m music_style_transfer_ldm_tpu_torch.cli generate \\
      --checkpoint ckpt.pt --style s.png
  python -m music_style_transfer_ldm_tpu_torch.cli serve --checkpoint ckpt.pt
  python -m music_style_transfer_ldm_tpu_torch.cli generate-pairings \\
      --root images/ --output pairs.csv
  python -m music_style_transfer_ldm_tpu_torch.cli train --model \\
      autoencoder --data-root images/ --epochs N --out-dir runs/ae
  python -m music_style_transfer_ldm_tpu_torch.cli train --model ldm \\
      --data-root images/ --pairing-file pairs.csv \\
      --pretrained-ae runs/ae/pretrained.pt --epochs N --out-dir runs/ldm
  python -m music_style_transfer_ldm_tpu_torch.cli import-torch \\
      --encoder encoder.pth --decoder decoder.pth --out ae.pt
  python -m music_style_transfer_ldm_tpu_torch.cli distill \\
      --checkpoint runs/ldm/ldm_final.pt --data-root images/ \\
      --pairing-file pairs.csv --out-dir runs/distill
  python -m music_style_transfer_ldm_tpu_torch.cli diagnose --checkpoint ckpt.pt
  python -m music_style_transfer_ldm_tpu_torch.cli bench
  python -m torch.distributed.run --nproc-per-node N \\
      -m music_style_transfer_ldm_tpu_torch.cli train --model ldm ...
  python -m music_style_transfer_ldm_tpu_torch.cli serve --mesh-dp N ...

``download`` fetches audio with yt-dlp (optional; not on the card's
machine); ``build-dataset`` turns it into the PNG tree (or, with
``--parquet``, a parquet file; needs pandas) that ``generate-pairings``
and ``train`` read.  Checkpoints are the port's own format (``training/checkpoint.py``).
``train --model autoencoder`` writes ``pretrained.pt`` (the best
validation loss), which ``train --model ldm --pretrained-ae`` loads and
freezes; ``train --model ldm`` writes ``ldm_final.pt``, which
``transfer`` and ``generate`` read.  ``import-torch`` converts the
reference's own ``.pth`` weights into these formats.  ``distill`` writes
one ``distilled_<n>.pt`` per stage, an n-step student that ``transfer``
and ``serve`` sample at ``--steps <t_max> --sample-steps <n + 1>``.
``bench`` prints the headline numbers of the flagship model, random
weights, as JSON lines (``benchmarks.py``).

``transfer`` and ``serve`` take ``--model riffusion-v1`` (Riffusion v1,
``models/riffusion.py``): 512x512 spectrograms at 44.1 kHz, SDEdit from
``--steps`` (750 of its 1,000: strength 0.75) at ``--guidance`` (7.0)
over ``--sample-steps`` (38) grid points; the defaults are
``RiffusionConfig``'s.  Its prompt is token ids
(``--prompt-ids 123,456``; ``prompt_ids`` in the JSON of ``/v1/transfer``
and ``/v1/generate``): CLIP's BPE tokenizer needs its ``vocab.json`` and
``merges.txt``, which are not in the repository.  ``--checkpoint`` is a
``torch.save`` of {"text_encoder", "unet", "vae"} state dicts under
diffusers' and transformers' names; without one the weights are seeded.
Everything runs on the card; ``--device cpu`` runs the plain PyTorch
versions of the kernels on the CPU instead (the tests use it).

``train`` and ``distill`` start a process group when
``torch.distributed.run`` launched them (``parallel/distributed.py``):
each rank trains on its own card (``cuda:LOCAL_RANK``; with ``--device
cpu`` on the CPU over gloo) and loads its slice of every global batch of
128, and rank 0 writes.  ``serve --mesh-dp N`` runs one model replica on
each of the first N cards (N CPU replicas with ``--device cpu``) and
splits every bucket over them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio.io import load_audio, write_wav
from music_style_transfer_ldm_tpu_torch.audio.processor import (
    AudioProcessor, crossfade_stitch,
)
from music_style_transfer_ldm_tpu_torch.audio import riffusion as riff_audio
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    unit_image_to_uint8,
)
from music_style_transfer_ldm_tpu_torch.audio.stft import stft_np
from music_style_transfer_ldm_tpu_torch.config import (
    RiffusionConfig, default_config,
)
from music_style_transfer_ldm_tpu_torch.data.build_dataset import (
    build_dataset_df, build_dataset_folder_structure, chunk_audio,
)
from music_style_transfer_ldm_tpu_torch.data.downloader import AudioDownloader
from music_style_transfer_ldm_tpu_torch.datasets.folder import (
    SpectrogramPairDataset, generate_pairings, load_image_unit,
)
from music_style_transfer_ldm_tpu_torch.models.clip_text import prompt_ids
from music_style_transfer_ldm_tpu_torch.models.riffusion import (
    load_riffusion, riffusion_transfer,
)
from music_style_transfer_ldm_tpu_torch.datasets.loader import (
    BatchLoader, prepare_dataset,
)
from music_style_transfer_ldm_tpu_torch.evaluation.diagnostics import (
    detect_dead_style_encoder, parameter_table, style_embedding_stats,
)
from music_style_transfer_ldm_tpu_torch.interop.torch_weights import (
    convert_autoencoder_state_dicts, convert_ldm_state_dict,
)
from music_style_transfer_ldm_tpu_torch.losses.lpips import (
    LPIPS, convert_torch_lpips_state_dict,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import (
    VGGishFeatures, convert_torchvggish_state_dict,
)
from music_style_transfer_ldm_tpu_torch.models.autoencoder import (
    SpectrogramDecoder, SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    build_ldm, checkpoint_distill_meta, content_style_transfer, load_ldm,
    match_moments, style_ddim_sample,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
    fused_content_style_transfer, fused_style_sample,
)
from music_style_transfer_ldm_tpu_torch.parallel import (
    initialize, make_mesh, process_info, shutdown,
)
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine,
)
from music_style_transfer_ldm_tpu_torch.serving.server import serve
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt_lib
from music_style_transfer_ldm_tpu_torch.training.distill import (
    ProgressiveDistiller,
)
from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (
    AETrainer,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer
from music_style_transfer_ldm_tpu_torch.utils.chips import (
    deterministic_convs, fused_bucket_max,
)
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

# Images are read by utils/png.py, which takes PNG only: another image
# type raises there rather than being decoded as audio.
_IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg", ".bmp")
SAMPLERS = ["ddim", "dpm++", "fused", "fused-dpm++"]
RIFFUSION = "riffusion-v1"
MODELS = ["ldm", RIFFUSION]


def _require(args, *names) -> None:
    for name in names:
        if getattr(args, name) is None:
            raise SystemExit(f"--{name.replace('_', '-')} is required for "
                             f"--model {args.model}")


def parse_prompt_ids(text) -> list:
    """'12,345 6' -> [12, 345, 6] (commas or spaces); None or '' -> the
    empty prompt."""
    return [int(t) for t in str(text or "").replace(",", " ").split()]


def _load_riffusion(args, checkpoint):
    dtype = (torch.float32 if torch.device(args.device).type == "cpu"
             else torch.bfloat16)
    if checkpoint is None:
        print("note: no --checkpoint: Riffusion's weights are seeded",
              file=sys.stderr)
    return load_riffusion(checkpoint, dtype=dtype, device=args.device)


def chunk_seeds(seed: int, n: int) -> np.ndarray:
    """One noise seed per chunk from (seed, chunk index); no two (seed,
    index) pairs share a stream, unlike seed + index."""
    root = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([int(np.random.SeedSequence([root, i]).generate_state(
        1, np.uint64)[0]) >> 1 for i in range(n)], np.int64)


def _load_image_or_audio(path: str, ap, n_mels: int = 128) -> np.ndarray:
    """PNG spectrogram or audio file -> [1, 128, 128, 1] float image."""
    p = Path(path)
    if p.suffix.lower() in _IMAGE_SUFFIXES:
        return load_image_unit(p)[None]
    audio, _ = ap.load_audio(p)
    audio = ap.trim_silence(audio)
    return ap.clip_to_content_image(audio, n_mels=n_mels)[None]


def _audio_to_chunk_images(path: str, ap, n_mels: int = 128,
                           overlap: float = 0.0):
    """Whole clip -> ([n, 128, 128, 1] images, [n, samples] chunks): 3 s
    chunks (the last zero-padded), overlapping by ``overlap``, through
    the front end as one batch.  Each chunk's dB reference is taken over
    all its frames before the crop to 128."""
    audio, sr = ap.load_audio(path)
    audio = ap.trim_silence(audio)
    hop_s = 3.0 * (1.0 - overlap) if overlap else None
    chunks = chunk_audio(audio, sr, 3.0, None, hop_seconds=hop_s)
    imgs = ap.waveform_batch_to_unit_images(chunks, n_mels=n_mels)
    return imgs[:, :, :128, None].cpu().numpy().astype(np.float32), chunks


def _save_outputs(img01: np.ndarray, output: str, ap,
                  init_phase: np.ndarray | None = None,
                  hop_samples: int | None = None) -> None:
    """Write <output>.png (the spectrogram) and <output>.wav.

    img01 is [H, W] or [N, H, W] (a chunked clip: the PNG tiles the
    chunks side by side, the chunks are inverted as one batch and
    stitched into one WAV).  Audio is inverted from the uint8-quantized
    image, i.e. from what the PNG holds."""
    out = Path(output)
    out.parent.mkdir(parents=True, exist_ok=True)
    sr = ap.target_sr
    batched = img01.ndim == 3
    u8 = unit_image_to_uint8(torch.as_tensor(img01)).numpy()
    png = np.concatenate(list(u8), axis=1) if batched else u8
    out.with_suffix(".png").write_bytes(write_png_gray(png))
    audio = ap.grayscale_mel_spectrogram_image_to_audio(
        u8, length=3 * sr, init_phase=init_phase).cpu().numpy()
    if batched:
        audio = crossfade_stitch(
            audio, audio.shape[1] if hop_samples is None else hop_samples)
    write_wav(out.with_suffix(".wav"), audio, sr)
    print(f"wrote {out.with_suffix('.png')} and {out.with_suffix('.wav')}")


def _restore(args):
    """(config, ldm, AudioProcessor) on ``--device``."""
    cfg = default_config()
    ldm = load_ldm(cfg, full_checkpoint=args.checkpoint,
                   use_ema=not args.raw_weights, device=args.device)
    return cfg, ldm, AudioProcessor(device=args.device)


def _warn_distill_mismatch(args) -> None:
    """Warn when a distilled student is sampled off its training grid: a
    student distilled with t_max T to N steps only saw linspace(T-1, 0,
    N+1).  Advisory only."""
    meta = checkpoint_distill_meta(args.checkpoint)
    if not meta:
        return
    want_steps = int(meta.get("t_max", args.steps))
    want_sample = int(meta.get("steps", 0)) + 1
    got_sample = (args.sample_steps if args.sample_steps is not None
                  else args.steps)
    if int(args.steps) != want_steps or int(got_sample) != want_sample:
        print(f"WARNING: checkpoint was distilled for --steps {want_steps} "
              f"--sample-steps {want_sample}, but got --steps {args.steps} "
              f"--sample-steps {got_sample}: the student never trained on "
              f"this grid and output quality will degrade silently",
              file=sys.stderr)


def _warn_generate_distill_mismatch(args, num_timesteps: int) -> None:
    """Generation walks linspace(T-1, 0, --steps) over the whole
    schedule: a distilled student is on its grid only when distilled with
    t_max == T and --steps == its steps + 1.  Advisory only."""
    meta = checkpoint_distill_meta(args.checkpoint)
    if not meta:
        return
    t_max = int(meta.get("t_max", num_timesteps))
    want = int(meta.get("steps", 0)) + 1
    if t_max != num_timesteps:
        print(f"WARNING: checkpoint was distilled for TRANSFER over "
              f"t_max={t_max} (< the full T={num_timesteps} schedule); "
              "generation from noise walks timesteps it never trained on "
              "and output quality will degrade silently",
              file=sys.stderr)
    elif int(args.steps) != want:
        print(f"WARNING: generation-distilled checkpoint expects "
              f"--steps {want} (its training grid), got {args.steps}: "
              "off-grid sampling degrades silently", file=sys.stderr)


def _check_guidance(args) -> None:
    if args.sampler in ("fused", "fused-dpm++") and args.guidance != 1.0:
        raise SystemExit("--guidance needs the scan samplers (ddim/dpm++); "
                         "the fused trajectory kernel runs the single "
                         "conditional branch only")


@deterministic_convs()
def cmd_generate(args) -> int:
    """Style-conditioned generation from noise (cuDNN's deterministic
    algorithms: the same seed gives the same WAV)."""
    cfg, ldm, ap = _restore(args)
    _warn_generate_distill_mismatch(args, cfg.diffusion.num_timesteps)
    _check_guidance(args)
    style = torch.as_tensor(_load_image_or_audio(args.style, ap))
    lat = cfg.model.image_size // 8
    z_shape = (1, lat, lat, cfg.model.latent_dim)
    if args.sampler in ("fused", "fused-dpm++"):
        decoded = fused_style_sample(
            ldm, z_shape, style, timesteps=args.steps, eta=args.eta,
            sampler="dpm++" if args.sampler == "fused-dpm++" else "ddim",
            seed=args.seed)
    else:
        decoded = style_ddim_sample(
            ldm, z_shape, style, timesteps=args.steps, eta=args.eta,
            sampler=args.sampler, guidance=args.guidance, seed=args.seed)
    _save_outputs(decoded[0, :, :, 0].cpu().numpy(), args.output, ap)
    return 0


@deterministic_convs()
def cmd_transfer(args) -> int:
    """Content + style transfer, the product path (cuDNN's deterministic
    algorithms: the same seed gives the same WAV).

    Content audio of any length is cut into 3 s chunks that go through
    the sampler together (the fused samplers in groups of
    ``fused_bucket_max()``); each chunk's noise comes from (--seed, its
    index), so the result does not depend on the grouping.  The chunks'
    audio is stitched back into one WAV."""
    if args.model == RIFFUSION:
        return _transfer_riffusion(args, _load_riffusion(args,
                                                         args.checkpoint))
    _require(args, "checkpoint", "style")
    _, ldm, ap = _restore(args)
    _warn_distill_mismatch(args)
    _check_guidance(args)
    if not 0.0 <= args.overlap < 1.0:
        raise SystemExit(f"--overlap must be in [0, 1); got {args.overlap}")
    content_chunks = None
    if Path(args.content).suffix.lower() in _IMAGE_SUFFIXES:
        if args.overlap:
            raise SystemExit("--overlap needs audio content "
                             "(got a spectrogram image)")
        content = _load_image_or_audio(args.content, ap)
    else:
        content, content_chunks = _audio_to_chunk_images(
            args.content, ap, overlap=args.overlap)
    n = content.shape[0]
    style = np.repeat(_load_image_or_audio(args.style, ap), n, axis=0)
    seeds = chunk_seeds(args.seed, n)
    content_t, style_t = torch.as_tensor(content), torch.as_tensor(style)
    if args.sampler in ("fused", "fused-dpm++"):
        cap = fused_bucket_max()
        inner = "dpm++" if args.sampler == "fused-dpm++" else "ddim"
        decoded = torch.cat([fused_content_style_transfer(
            ldm, content_t[lo:lo + cap], style_t[lo:lo + cap],
            num_timesteps=args.steps, eta=args.eta, sampler=inner,
            steps=args.sample_steps, seeds=seeds[lo:lo + cap])
            for lo in range(0, n, cap)])
    else:
        decoded, _ = content_style_transfer(
            ldm, content_t, style_t, num_timesteps=args.steps, eta=args.eta,
            sampler=args.sampler, steps=args.sample_steps,
            guidance=args.guidance, seeds=seeds)
    if args.match_level:
        decoded = match_moments(decoded, style_t.to(decoded.device))
    else:
        out_level = float(decoded.mean())
        ref_level = float(style.mean())
        if out_level < 0.5 * ref_level:
            print(f"note: output global level ({out_level:.3f}) is well "
                  f"below the style reference's ({ref_level:.3f}); the "
                  "inverted audio may be very quiet. Re-run with "
                  "--match-level to moment-match the output to the style.",
                  file=sys.stderr)
    init_phase = None
    if args.phase_init == "content":
        if content_chunks is None:
            raise SystemExit("--phase-init content needs audio content "
                             "(got a spectrogram image)")
        # Seed Griffin-Lim with the content chunks' own phases.
        spec = stft_np(content_chunks, n_fft=ap.n_fft,
                       hop_length=ap.hop_length)
        init_phase = np.angle(spec[:, :, :128]).astype(np.float32)
    hop_samples = (int(3 * (1.0 - args.overlap) * ap.target_sr)
                   if args.overlap else None)
    _save_outputs(decoded[:, :, :, 0].cpu().numpy(), args.output, ap,
                  init_phase=init_phase, hop_samples=hop_samples)
    return 0


def _riffusion_content(path: str, model, device) -> torch.Tensor:
    """A PNG (cropped or padded to the model's size) or audio cut into
    clip_seconds chunks (the last zero-padded) through Riffusion's front
    end -> [n, S, S] unit images on ``device``."""
    S, a = model.image_size, model.audio_config
    if Path(path).suffix.lower() in _IMAGE_SUFFIXES:
        return torch.as_tensor(load_image_unit(path, S)[None, ..., 0],
                               device=device)
    y, _ = load_audio(path, sr=a.sample_rate)
    n = int(round(a.clip_seconds * a.sample_rate))
    chunks = max(1, -(-len(y) // n))
    y = np.pad(np.asarray(y, np.float32), (0, chunks * n - len(y)))
    return riff_audio.waveform_to_unit_images(y.reshape(chunks, n), a, S,
                                              device)


def _transfer_riffusion(args, model) -> int:
    """``cli transfer --model riffusion-v1``: content (audio or a
    spectrogram image) restyled under ``--prompt-ids``; writes the
    chunks' images side by side and their audio end to end."""
    content = _riffusion_content(args.content, model, model.device)
    n = content.shape[0]
    ids = prompt_ids(parse_prompt_ids(args.prompt_ids), model.config.text)
    decoded = riffusion_transfer(
        model, content[..., None], model.condition(np.repeat(ids[None], n, 0)),
        num_timesteps=args.steps,
        steps=args.sample_steps or model.config.sample_steps,
        guidance=args.guidance, seeds=chunk_seeds(args.seed, n))[..., 0]
    audio = riff_audio.image_to_audio(decoded, model.audio_config)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    u8 = unit_image_to_uint8(decoded.cpu()).numpy()
    out.with_suffix(".png").write_bytes(write_png_gray(
        np.concatenate(list(u8), axis=1)))
    write_wav(out.with_suffix(".wav"), riff_audio.peak_normalize(
        audio.cpu().numpy().reshape(-1)), model.audio_config.sample_rate)
    print(f"wrote {out.with_suffix('.png')} and {out.with_suffix('.wav')}")
    return 0


def _riffusion_engine(args):
    """``serve --model riffusion-v1``'s engine (one card)."""
    if args.mesh_dp != 1 or len(args.checkpoint or ()) > 1:
        raise SystemExit("--model riffusion-v1 serves one model on one card")
    model = _load_riffusion(args, (args.checkpoint or [None])[0])
    ecfg = EngineConfig(
        steps=args.steps,
        sampler=args.sampler,
        sample_steps=args.sample_steps or model.config.sample_steps,
        guidance=args.guidance, generate_steps=args.generate_steps,
        generate_guidance=args.generate_guidance,
        batch_buckets=tuple(args.buckets), max_wait_ms=args.max_wait_ms,
        autoscale=args.autoscale)
    return InferenceEngine(model, ecfg)


def _serve_engine_config(ecfg, args, path, name, num_timesteps: int = 200):
    """A distilled student serves on its trained grid unless the user
    pinned --sample-steps (then an off-grid choice warns)."""
    meta = checkpoint_distill_meta(path)
    if not meta:
        return ecfg
    want_steps = int(meta.get("t_max", args.steps))
    want_sample = int(meta.get("steps", 0)) + 1
    # A whole-schedule (generation) cascade's grid also serves
    # /v1/generate unless the user pinned one.
    gen_kw = {}
    if args.generate_steps is None and want_steps == num_timesteps:
        gen_kw = {"generate_steps": want_sample}
    if args.sample_steps is None:
        print(f"{name}: distilled checkpoint (stages {meta.get('stages')}):"
              f" serving on its trained grid steps={want_steps} "
              f"sample_steps={want_sample}"
              + (f" (generate route: {want_sample})" if gen_kw else ""),
              flush=True)
        return dataclasses.replace(ecfg, steps=want_steps,
                                   sample_steps=want_sample, **gen_kw)
    if int(args.steps) != want_steps or int(args.sample_steps) != want_sample:
        print(f"WARNING: {name}: checkpoint was distilled for --steps "
              f"{want_steps} --sample-steps {want_sample}, but serving with "
              f"--steps {args.steps} --sample-steps {args.sample_steps}: "
              "the student never trained on this grid and output quality "
              "will degrade silently", file=sys.stderr)
    return ecfg


def serving_mesh(args):
    """``--mesh-dp N``: a mesh over the first N cards, or N CPU replicas
    with ``--device cpu``; None for N = 1.  N above the card count is
    refused."""
    n = args.mesh_dp
    if n < 1:
        raise SystemExit(f"--mesh-dp {n}: must be at least 1")
    if n == 1:
        return None
    if torch.device(args.device).type == "cpu":
        return make_mesh((n, 1), devices=["cpu"] * n)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > count:
        raise SystemExit(f"--mesh-dp {n}: {count} card(s) on this machine")
    return make_mesh((n, 1), devices=[f"cuda:{i}" for i in range(n)])


def build_engines(args) -> dict:
    """{name: warmed InferenceEngine} for ``serve``'s --checkpoint entries
    (a bare path, or name=path; the first is the default model), or
    Riffusion's one engine.  Warming builds every kernel, before anything
    listens."""
    if args.model == RIFFUSION:
        engines = {"default": _riffusion_engine(args)}
        print(f"warming {len(args.buckets)} batch buckets of "
              f"{RIFFUSION}...", flush=True)
        engines["default"].warmup()
        return engines
    _require(args, "checkpoint")
    cfg = default_config()
    ecfg = EngineConfig(steps=args.steps, sampler=args.sampler,
                        sample_steps=args.sample_steps,
                        guidance=args.guidance,
                        generate_steps=args.generate_steps,
                        generate_guidance=args.generate_guidance,
                        batch_buckets=tuple(args.buckets),
                        max_wait_ms=args.max_wait_ms,
                        autoscale=args.autoscale)
    mesh = serving_mesh(args)
    engines = {}
    for spec in args.checkpoint:
        name, _, path = spec.rpartition("=")
        name = name or ("default" if not engines else
                        f"model{len(engines)}")
        ldm = load_ldm(cfg, full_checkpoint=path,
                       use_ema=not args.raw_weights, device=args.device)
        engines[name] = InferenceEngine(ldm, _serve_engine_config(
            ecfg, args, path, name, cfg.diffusion.num_timesteps),
            audio=cfg.audio, mesh=mesh)
    print(f"warming {len(args.buckets)} batch buckets x "
          f"{len(engines)} model(s)...", flush=True)
    for eng in engines.values():
        eng.warmup()
    return engines


def cmd_serve(args) -> int:
    """Run the HTTP inference server over one or more checkpoints."""
    engines = build_engines(args)
    engine = engines if len(engines) > 1 else next(iter(engines.values()))
    print(f"serving on http://{args.host}:{args.port}"
          + (" (bearer auth)" if args.auth_token else ""), flush=True)
    serve(engine, host=args.host, port=args.port, block=True,
          auth_token=args.auth_token, request_timeout_s=args.timeout,
          max_queue=args.max_queue)
    return 0


def cmd_download(args) -> int:
    dl = AudioDownloader(output_dir=args.output_dir)
    if args.csv:
        dl.download_from_csv(args.csv)
    elif args.file:
        dl.download_from_file(args.file)
    elif args.url:
        dl.download_audio(args.url, instrument=args.instrument or "")
        dl.report_failures()
    else:
        print("one of --csv/--file/--url is required", file=sys.stderr)
        return 2
    return 0


def cmd_build_dataset(args) -> int:
    """Audio -> the PNG tree (kernel C on the card, 64 chunks a batch),
    or with --parquet a parquet file of PNG bytes; prints the seconds of
    each stage."""
    if args.parquet:
        df = build_dataset_df(args.audio_dir, save_path=args.parquet,
                              chunk_size_sec=args.chunk_sec,
                              max_duration=args.max_duration,
                              n_mels=args.n_mels, device=args.device)
        print(f"wrote {len(df)} rows to {args.parquet}")
        return 0
    timings: dict = {}
    n = build_dataset_folder_structure(
        args.audio_dir, args.output_root, chunk_size_sec=args.chunk_sec,
        max_duration=args.max_duration, n_mels=args.n_mels,
        device=args.device, timings=timings)
    print(f"wrote {n} images under {args.output_root}")
    print(f"ETL seconds: {json.dumps(timings)}", flush=True)
    return 0


def cmd_generate_pairings(args) -> int:
    generate_pairings(args.root, args.output, num_pairs=args.num_pairs,
                      seed=args.seed)
    print(f"pairings saved to {args.output}")
    return 0


def _load_feature_params(path, expected_kind: str):
    """The weights of a feature checkpoint (``import-torch --vggish /
    --lpips``) for a trainer's metric; None passes through (a random
    trunk)."""
    if not path:
        return None
    payload = ckpt_lib.load_feature_checkpoint(path)
    kind = payload["kind"]
    if kind != expected_kind:
        raise SystemExit(
            f"feature checkpoint {path} holds {kind!r} weights but the "
            f"loss expects {expected_kind!r} (check --style-features vs "
            "--compression-features / train.compression_feature_extractor)")
    print(f"transplanted {kind} feature weights loaded from {path}",
          flush=True)
    return payload["params"]


def _start_process_group(args) -> tuple:
    """(started, process index, process count): the process group of a
    ``torch.distributed.run`` launch, each rank on ``cuda:LOCAL_RANK`` (or
    the device ``--device`` names); a single process stays as it is."""
    started = initialize(device=None if args.device == "cuda"
                         else args.device)
    info = process_info()
    return started, info["process_index"], info["process_count"]


def cmd_train(args) -> int:
    """Phase 1 (``--model autoencoder``: the image folder split 80/20,
    ``pretrained.pt`` at the best validation loss) or phase 2 (``--model
    ldm``: a pairings CSV over the image folder, optionally from phase 1's
    ``--pretrained-ae``; ``ldm_final.pt`` at the end).  Checkpoints go
    under --out-dir.  Under ``torch.distributed.run`` every rank trains
    on its slice of each global batch."""
    started, index, count = _start_process_group(args)
    try:
        return _train(args, index, count)
    finally:
        if started:
            shutdown()


def _train(args, index: int, count: int) -> int:
    main = index == 0
    cfg = default_config()
    overrides = {"num_epochs": args.epochs, "learning_rate": args.lr,
                 "style_dropout": args.style_dropout or None,
                 "ema_decay": args.ema_decay or None}
    cfg.train = dataclasses.replace(cfg.train, **{
        k: v for k, v in overrides.items() if v is not None})
    root = args.data_root or cfg.data.processed_dir
    if args.model == "autoencoder":
        ldm_only = [flag for flag, value in (
            ("--pretrained-ae", args.pretrained_ae),
            ("--pairing-file", args.pairing_file),
            ("--style-features", args.style_features),
            ("--compression-features", args.compression_features),
            ("--style-dropout", args.style_dropout),
            ("--ema-decay", args.ema_decay)) if value]
        if ldm_only:
            raise SystemExit(f"{', '.join(ldm_only)}: LDM only (train "
                             "--model ldm)")
        train_loader, val_loader = prepare_dataset(cfg, root, index, count)
        trainer = AETrainer(cfg, device=args.device)
        trainer.train(train_loader, val_loader, out_dir=args.out_dir,
                      resume_from=args.resume_from)
        if main:
            print(f"autoencoder: {len(train_loader)} train / "
                  f"{len(val_loader)} validation batches per epoch; best "
                  f"weights in {Path(args.out_dir) / 'pretrained.pt'} (for "
                  "train --model ldm --pretrained-ae)", flush=True)
        return 0
    pairs = SpectrogramPairDataset(root, args.pairing_file
                                   or cfg.data.pairing_file)
    loader = BatchLoader(pairs, cfg.train.batch_size, shuffle=True,
                         seed=cfg.train.seed, process_index=index,
                         process_count=count)
    trainer = LDMTrainer(
        cfg, device=args.device,
        style_feature_params=_load_feature_params(args.style_features,
                                                  "vggish"),
        compression_feature_params=_load_feature_params(
            args.compression_features,
            cfg.train.compression_feature_extractor))
    pre = (ckpt_lib.load_autoencoder(args.pretrained_ae)
           if args.pretrained_ae else None)
    trainer.train(loader, pretrained_autoencoder=pre, out_dir=args.out_dir,
                  resume_from=args.resume_from)
    if main:
        print(f"trained {len(loader)} steps per epoch; checkpoints under "
              f"{args.out_dir}", flush=True)
    return 0


def _load_state_dict(path) -> dict:
    """A PyTorch state dict file (or a {'state_dict': ...} wrapper, as
    torch.hub modules save them), tensors only."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


def cmd_import_torch(args) -> int:
    """Convert the reference's PyTorch weights into the port's formats
    (``interop/torch_weights.py``): ``--ldm`` a full checkpoint for
    transfer / generate / serve, ``--encoder --decoder`` an autoencoder
    checkpoint for ``train --pretrained-ae`` and ``load_ldm(
    autoencoder_checkpoint=)``, ``--vggish`` / ``--lpips`` a feature
    checkpoint for ``train --style-features`` / ``--compression-features``
    (torchvggish's ``features`` and ``lpips.LPIPS(net='alex')`` layouts).
    Each is loaded into its module strictly before it is written."""
    out = Path(args.out)
    if args.vggish or args.lpips:
        kind = "vggish" if args.vggish else "lpips"
        convert = (convert_torchvggish_state_dict if args.vggish
                   else convert_torch_lpips_state_dict)
        params = convert(_load_state_dict(args.vggish or args.lpips))
        module = VGGishFeatures() if args.vggish else LPIPS()
        module.load_state_dict(params)
        ckpt_lib.save_feature_checkpoint(out, kind, module.state_dict())
    elif args.ldm:
        model = build_ldm(device="cpu")
        model.load_state_dict(convert_ldm_state_dict(
            _load_state_dict(args.ldm)))
        ckpt_lib.save_checkpoint(out, model)
    elif args.encoder and args.decoder:
        cm = default_config().model
        params = convert_autoencoder_state_dicts(
            _load_state_dict(args.encoder), _load_state_dict(args.decoder))
        encoder = SpectrogramEncoder(cm.latent_dim)
        decoder = SpectrogramDecoder(cm.latent_dim)
        encoder.load_state_dict(params["encoder"])
        decoder.load_state_dict(params["decoder"])
        ckpt_lib.save_autoencoder(out, encoder, decoder)
    else:
        print("provide --ldm, --vggish, --lpips, or --encoder and "
              "--decoder", file=sys.stderr)
        return 2
    print(f"converted checkpoint written to {out}")
    return 0


def cmd_distill(args) -> int:
    """Progressive distillation of the transfer sampler
    (``training/distill.py``) from a full checkpoint (its EMA weights when
    it has them) over a pairings CSV; one ``distilled_<n>.pt`` per stage
    under --out-dir.  Under ``torch.distributed.run`` every rank takes its
    slice of each global batch."""
    started, index, count = _start_process_group(args)
    try:
        return _distill(args, index, count)
    finally:
        if started:
            shutdown()


def _distill(args, index: int, count: int) -> int:
    cfg = default_config()
    if args.batch_size:
        cfg.train = dataclasses.replace(cfg.train,
                                        batch_size=args.batch_size)
    dist = ProgressiveDistiller(cfg, t_max=args.t_max, device=args.device)
    root = args.data_root or cfg.data.processed_dir
    pairs = SpectrogramPairDataset(root, args.pairing_file
                                   or cfg.data.pairing_file)
    loader = BatchLoader(pairs, cfg.train.batch_size, shuffle=True,
                         seed=cfg.train.seed, process_index=index,
                         process_count=count)
    teacher = load_ldm(cfg, full_checkpoint=args.checkpoint,
                       dtype=torch.float32, device=dist.device)
    stages = [int(s) for s in args.stages.split(",") if s]
    _, info = dist.distill(teacher, loader, stages=stages,
                           steps_per_stage=args.steps_per_stage,
                           lr=args.lr, out_dir=args.out_dir,
                           seed=cfg.train.seed, guidance=args.guidance,
                           inflight_every=args.inflight_every)
    final = info["steps"]
    if index:
        return 0
    # The student only saw linspace(t_max - 1, 0, N + 1): --steps must be
    # the distillation's t_max.
    print(f"distilled to {final} steps; transfer with "
          f"--steps {info['t_max']} --sample-steps {final + 1} "
          f"(grids: {info['stages']} -> {final})"
          f"; checkpoints under {args.out_dir}")
    return 0


def cmd_diagnose(args) -> int:
    """The parameter table and the dead-style-encoder probe (the style
    pyramid's spread over 8 seeded random styles) of a checkpoint."""
    cfg = default_config()
    ldm = load_ldm(cfg, full_checkpoint=args.checkpoint,
                   use_ema=not args.raw_weights, device=args.device)
    table = parameter_table(ldm)
    print("parameter counts:")
    for k, v in table.items():
        print(f"  {k:<16} {v:>12,}")
    rng = np.random.RandomState(0)
    styles = rng.rand(8, cfg.model.image_size, cfg.model.image_size,
                      1).astype(np.float32)
    with torch.no_grad():
        embs = ldm.style_embed(torch.as_tensor(styles))
    stats = style_embedding_stats(embs)
    dead = detect_dead_style_encoder(embs)
    print("style embedding stats (std ~ 0 across distinct styles = dead):")
    for k in sorted(stats):
        flag = "  DEAD" if dead[k] else ""
        print(f"  {k}: std={stats[k]['std']:.5f} "
              f"zero_frac={stats[k]['zero_fraction']:.3f}{flag}")
    return 0


def cmd_bench(args) -> int:
    """The headline benchmark (``benchmarks.py``): JSON lines on stdout;
    a section that fails raises after the fields measured so far."""
    from music_style_transfer_ldm_tpu_torch.benchmarks import (
        main as bench_main,
    )
    bench_main(device=args.device)
    return 0


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions (tests)")
    p.add_argument("--raw-weights", action="store_true",
                   help="use the raw (non-EMA) weights even when the "
                        "checkpoint carries ema_params")


class _Parser(argparse.ArgumentParser):
    """Fills each option a command lists in its ``model_defaults``
    ({dest: {model: value}}) that the command line left unset, by the
    command's ``--model``."""

    def parse_known_args(self, args=None, namespace=None):
        ns, rest = super().parse_known_args(args, namespace)
        for dest, by_model in getattr(ns, "model_defaults", {}).items():
            if getattr(ns, dest) is None:
                setattr(ns, dest, by_model[ns.model])
        return ns, rest


def _model_args(p: argparse.ArgumentParser, steps: int,
                generate: bool = False) -> None:
    """``--model``, and the defaults it sets: ``--steps`` (``steps``
    for the LDM), ``--guidance`` and, with ``generate``,
    ``--generate-guidance`` (1 for the LDM); RiffusionConfig's for
    riffusion-v1."""
    p.add_argument("--model", choices=MODELS, default="ldm",
                   help="the paper's LDM, or Riffusion v1 (512x512 "
                        "spectrograms, text prompts as token ids)")
    rc = RiffusionConfig()
    defaults = {"steps": {"ldm": steps, RIFFUSION: rc.transfer_timesteps},
                "guidance": {"ldm": 1.0, RIFFUSION: rc.guidance}}
    if generate:
        defaults["generate_guidance"] = defaults["guidance"]
    p.set_defaults(model_defaults=defaults)


def build_parser() -> argparse.ArgumentParser:
    p = _Parser(prog="music_style_transfer_ldm_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    gen = sub.add_parser("generate", help="style-conditioned generation")
    gen.add_argument("--checkpoint", required=True)
    gen.add_argument("--style", required=True)
    gen.add_argument("--steps", type=int, default=100)
    gen.add_argument("--eta", type=float, default=0.0)
    gen.add_argument("--sampler", choices=SAMPLERS, default="ddim",
                     help="'fused*' run the whole trajectory as one kernel")
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--guidance", type=float, default=1.0,
                     help="classifier-free style-guidance scale (0 = "
                          "unconditional, 1 = plain conditional; needs a "
                          "checkpoint trained with style_dropout > 0; scan "
                          "samplers only)")
    gen.add_argument("--output", default="outputs/generated")
    _common(gen)
    gen.set_defaults(fn=cmd_generate)

    tr = sub.add_parser("transfer", help="content+style transfer")
    _model_args(tr, steps=100)
    tr.add_argument("--checkpoint", default=None,
                    help="required for --model ldm; optional for "
                         "riffusion-v1 (seeded weights without one)")
    tr.add_argument("--content", required=True)
    tr.add_argument("--style", default=None,
                    help="style image or audio (--model ldm)")
    tr.add_argument("--prompt-ids", default=None,
                    help="riffusion-v1: the prompt's CLIP token ids, "
                         "comma-separated (none: the empty prompt)")
    tr.add_argument("--steps", type=int, default=None,
                    help="noising depth (default 100; riffusion-v1: 750)")
    tr.add_argument("--eta", type=float, default=0.0)
    tr.add_argument("--sampler", choices=SAMPLERS, default="ddim",
                    help="'fused*' run the whole trajectory as one kernel "
                         "(fused-dpm++ = second-order update, use with "
                         "--sample-steps)")
    tr.add_argument("--sample-steps", type=int, default=None,
                    help="coarse sampler grid (< --steps noising depth); "
                         "pairs with --sampler dpm++/fused-dpm++")
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--guidance", type=float, default=None,
                    help="classifier-free style-strength knob (0 = ignore "
                         "style, 1 = plain conditional, the default, > 1 = "
                         "amplified style; needs a checkpoint trained with "
                         "style_dropout > 0; scan samplers only); "
                         "riffusion-v1: the prompt's, default 7")
    tr.add_argument("--overlap", type=float, default=0.0,
                    help="fraction in [0, 1): overlapping 3 s chunks with "
                         "crossfaded seams; 0 = disjoint chunks")
    tr.add_argument("--phase-init", choices=["random", "content"],
                    default="random",
                    help="Griffin-Lim phase seed: 'content' reuses the "
                         "content audio's own phases")
    tr.add_argument("--match-level", action="store_true",
                    help="affine-match each output's global level and "
                         "contrast to its style image")
    tr.add_argument("--output", default="outputs/transferred")
    _common(tr)
    tr.set_defaults(fn=cmd_transfer)

    sv = sub.add_parser("serve", help="HTTP inference server (microbatched)")
    _model_args(sv, steps=50, generate=True)
    sv.add_argument("--checkpoint", default=None, action="append",
                    help="checkpoint path, or name=path (repeat for "
                         "multi-model routing; the first is the default); "
                         "required for --model ldm, at most one for "
                         "riffusion-v1")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8787)
    sv.add_argument("--steps", type=int, default=None,
                    help="noising depth (default 50; riffusion-v1: 750)")
    sv.add_argument("--sampler", choices=SAMPLERS, default="ddim",
                    help="'fused*' run the trajectory kernel on buckets up "
                         "to fused_bucket_max()")
    sv.add_argument("--sample-steps", type=int, default=None,
                    help="coarse sampler grid (< --steps noising depth)")
    sv.add_argument("--guidance", type=float, default=None,
                    help="classifier-free style-guidance scale (scan "
                         "samplers only; default 1, riffusion-v1: 7)")
    sv.add_argument("--generate-steps", type=int, default=None,
                    help="step grid of /v1/generate (default: --steps)")
    sv.add_argument("--generate-guidance", type=float, default=None,
                    help="guidance of /v1/generate (default 1, "
                         "riffusion-v1: 7)")
    sv.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    sv.add_argument("--mesh-dp", type=int, default=1,
                    help="one model replica on each of the first N cards "
                         "(N CPU replicas with --device cpu); every "
                         "bucket rounds up to a multiple of N and splits "
                         "over them")
    sv.add_argument("--max-wait-ms", type=float, default=5.0)
    sv.add_argument("--auth-token", default=None,
                    help="require 'Authorization: Bearer <token>'")
    sv.add_argument("--timeout", type=float, default=120.0,
                    help="per-request engine wait bound (504 past it)")
    sv.add_argument("--max-queue", type=int, default=256,
                    help="shed load with 429 when this many requests queue")
    sv.add_argument("--autoscale", action="store_true",
                    help="warm larger batch buckets when demand saturates "
                         "the current largest")
    _common(sv)
    sv.set_defaults(fn=cmd_serve)

    d = sub.add_parser("download", help="download audio via yt-dlp")
    d.add_argument("--csv")
    d.add_argument("--file")
    d.add_argument("--url")
    d.add_argument("--instrument")
    d.add_argument("--output-dir", default="downloads")
    d.set_defaults(fn=cmd_download)

    b = sub.add_parser("build-dataset", help="audio -> spectrogram images")
    b.add_argument("--audio-dir", default="downloads")
    b.add_argument("--output-root", default="processed_images")
    b.add_argument("--parquet", help="write parquet instead of PNG tree")
    b.add_argument("--chunk-sec", type=float, default=3.0)
    b.add_argument("--max-duration", type=float, default=1800.0)
    b.add_argument("--n-mels", type=int, default=128)
    b.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs kernel C's plain "
                        "PyTorch version (tests)")
    b.set_defaults(fn=cmd_build_dataset)

    g = sub.add_parser("generate-pairings", help="deterministic pair CSV")
    g.add_argument("--root", default="processed_images")
    g.add_argument("--output", default="spectrogram_pair_dataset_pairings.csv")
    g.add_argument("--num-pairs", type=int, default=15000)
    g.add_argument("--seed", type=int, default=42)
    g.set_defaults(fn=cmd_generate_pairings)

    t = sub.add_parser("train", help="train the autoencoder (phase 1) or "
                                     "the ldm (phase 2)")
    t.add_argument("--model", required=True, choices=["autoencoder", "ldm"])
    t.add_argument("--data-root")
    t.add_argument("--pairing-file", help="LDM only: the pairings CSV")
    t.add_argument("--pretrained-ae",
                   help="LDM only: autoencoder checkpoint to load and freeze "
                        "(phase 1's pretrained.pt, or import-torch "
                        "--encoder --decoder)")
    t.add_argument("--epochs", type=int)
    t.add_argument("--lr", type=float, default=None,
                   help="override the initial learning rate")
    t.add_argument("--style-dropout", type=float, default=0.0,
                   help="LDM only: per-sample probability of zeroing the "
                        "style embedding (classifier-free-guidance training)")
    t.add_argument("--ema-decay", type=float, default=0.0,
                   help="LDM only: track an EMA of the weights (0.999 "
                        "typical; 0 = off); inference then prefers it")
    t.add_argument("--style-features",
                   help="LDM only: transplanted VGGish feature checkpoint "
                        "(import-torch --vggish) for the style loss; "
                        "default a fixed-seed random trunk")
    t.add_argument("--compression-features",
                   help="LDM only: transplanted LPIPS feature checkpoint "
                        "(import-torch --lpips) for the compression "
                        "perceptual term")
    t.add_argument("--out-dir", default="runs/train")
    t.add_argument("--resume-from",
                   help="train-state checkpoint to resume from")
    t.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "PyTorch versions in f32 (tests)")
    t.set_defaults(fn=cmd_train)

    it = sub.add_parser("import-torch",
                        help="convert the reference's .pth weights")
    it.add_argument("--ldm", help="full ldm_<epoch>.pth state dict")
    it.add_argument("--encoder", help="encoder.pth")
    it.add_argument("--decoder", help="decoder.pth")
    it.add_argument("--vggish",
                    help="torchvggish .pth -> style-feature checkpoint "
                         "(train --style-features)")
    it.add_argument("--lpips",
                    help="lpips(net='alex') .pth -> compression-feature "
                         "checkpoint (train --compression-features)")
    it.add_argument("--out", required=True)
    it.set_defaults(fn=cmd_import_torch)

    dl = sub.add_parser(
        "distill", help="progressive sampler distillation: halve the "
                        "transfer grid stage by stage")
    dl.add_argument("--checkpoint", required=True,
                    help="converged full-LDM (or train-state) checkpoint")
    dl.add_argument("--data-root")
    dl.add_argument("--pairing-file")
    dl.add_argument("--out-dir", default="runs/distill")
    dl.add_argument("--stages", default="96,48,24,12,6",
                    help="comma-separated teacher step counts; each entry "
                         "distills a student with the NEXT entry's step "
                         "count (integer factor >= 2); the final student "
                         "= last//2, or 1 when the last entry is odd "
                         "(e.g. 48,24,12,6,3 ends at one denoiser eval)")
    dl.add_argument("--steps-per-stage", type=int, default=400)
    dl.add_argument("--inflight-every", type=int, default=200,
                    help="checkpoint the live stage every N steps and "
                         "resume an interrupted stage from it (0 = off)")
    dl.add_argument("--lr", type=float, default=1e-4)
    dl.add_argument("--batch-size", type=int)
    dl.add_argument("--t-max", type=int, default=100,
                    help="transfer noise level the grids cover (matches "
                         "`transfer --steps`)")
    dl.add_argument("--guidance", type=float, default=1.0,
                    help="distill a classifier-free-guided teacher at this "
                         "fixed scale (first stage only; needs a "
                         "style_dropout-trained checkpoint): the students "
                         "bake the amplified style in and sample unguided")
    dl.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs in f32 (tests)")
    dl.set_defaults(fn=cmd_distill)

    dg = sub.add_parser("diagnose", help="parameter table + dead-style-"
                                         "encoder probe on a checkpoint")
    dg.add_argument("--checkpoint", required=True)
    _common(dg)
    dg.set_defaults(fn=cmd_diagnose)

    be = sub.add_parser("bench", help="run the headline benchmark")
    be.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' times the plain PyTorch "
                         "versions on the host clock")
    be.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    from music_style_transfer_ldm_tpu_torch.utils.cache import (
        enable_compilation_cache,
    )
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
