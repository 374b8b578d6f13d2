"""The dataset ETL: audio files -> spectrogram images.

Each file under ``audio_dir/<instrument>/`` is loaded (mono, resampled to
22.05 kHz), trimmed of leading and trailing silence, cut into 3 s chunks
(the last zero-padded, only chunks that start before ``max_duration``)
and turned into 128-mel uint8 images, 64 chunks per device batch: power
spectra, then kernel C (``AudioProcessor.waveform_batch_to_unit_images``,
whose output lies on the /255 grid, so ``round(x * 255)`` is the uint8
exactly).  ``build_dataset_folder_structure`` writes them as
``<output_root>/<instrument>/<stem>_chunk<i>.png``;
``build_dataset_df`` keeps them as PNG bytes in a pandas DataFrame
(written to parquet).  PNGs are written by ``utils/png.py`` on the host.

``chunk_audio`` also cuts the transfer path's clips into model inputs.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio.processor import AudioProcessor
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

AUDIO_EXTENSIONS = (".mp3", ".wav", ".m4a", ".flac", ".ogg")
# The ETL's stages, the keys of ``timings``.
STAGES = ("read", "trim", "card", "png")


def chunk_audio(audio: np.ndarray, sr: int, chunk_seconds: float = 3.0,
                max_duration: Optional[float] = 1800.0,
                hop_seconds: Optional[float] = None) -> np.ndarray:
    """[T] -> [n_chunks, chunk_samples], zero-padding the last chunk and
    keeping only chunks that start before ``max_duration``.

    hop_seconds < chunk_seconds gives OVERLAPPING chunks (stitched back
    with ``audio.processor.crossfade_stitch``); the default hop equals
    the chunk (disjoint chunks)."""
    chunk = int(chunk_seconds * sr)
    hop = chunk if hop_seconds is None else max(1, int(hop_seconds * sr))
    starts = list(range(0, len(audio), hop))
    # Drop trailing windows that start past the signal.
    starts = [s for s in starts if s < len(audio)] or [0]
    if max_duration is not None:
        starts = [s for s in starts if (s / sr) < max_duration]
    out = np.zeros((len(starts), chunk), np.float32)
    for j, s in enumerate(starts):
        piece = audio[s:s + chunk]
        out[j, :len(piece)] = piece
    return out


def _audio_files(root: Path) -> List[Path]:
    return sorted(p for p in root.rglob("*")
                  if p.suffix.lower() in AUDIO_EXTENSIONS)


def _file_images(ap: AudioProcessor, audio_dir: str, chunk_size_sec: float,
                 max_duration: Optional[float], n_mels: int,
                 batch_chunks: int, timings: dict
                 ) -> Iterator[Tuple[Path, int, np.ndarray]]:
    """(file, first chunk index, uint8 [b, n_mels, F]) for every batch of
    up to ``batch_chunks`` chunks of every audio file, adding each
    stage's seconds to ``timings``."""
    for key in STAGES:
        timings.setdefault(key, 0.0)
    for f in _audio_files(Path(audio_dir)):
        t0 = time.perf_counter()
        audio, sr = ap.load_audio(f)
        t1 = time.perf_counter()
        audio = ap.trim_silence(audio)
        chunks = chunk_audio(audio, sr, chunk_size_sec, max_duration)
        t2 = time.perf_counter()
        timings["read"] += t1 - t0
        timings["trim"] += t2 - t1
        for start in range(0, len(chunks), batch_chunks):
            t0 = time.perf_counter()
            unit = ap.waveform_batch_to_unit_images(
                chunks[start:start + batch_chunks], n_mels=n_mels)
            imgs = torch.round(unit * 255.0).to(torch.uint8).cpu().numpy()
            timings["card"] += time.perf_counter() - t0
            yield f, start, imgs
        print(f"processed {f} -> {len(chunks)} chunks", flush=True)


def build_dataset_folder_structure(audio_dir: str = "downloads",
                                   output_root: str = "processed_images",
                                   chunk_size_sec: float = 3.0,
                                   max_duration: Optional[float] = 1800.0,
                                   n_mels: int = 128,
                                   batch_chunks: int = 64, device="cuda",
                                   timings: Optional[dict] = None) -> int:
    """Every audio file under ``audio_dir`` to PNG spectrograms under
    ``output_root/<instrument>/`` (the file's folder name); returns the
    number of images written.  ``timings``, when given, gains the
    seconds of each stage (``STAGES``: read and resample, trim and chunk,
    the device batches, PNG writes)."""
    ap = AudioProcessor(device=device)
    timings = {} if timings is None else timings
    written = 0
    for f, start, imgs in _file_images(ap, audio_dir, chunk_size_sec,
                                       max_duration, n_mels, batch_chunks,
                                       timings):
        t0 = time.perf_counter()
        out_dir = Path(output_root) / f.parent.name
        out_dir.mkdir(parents=True, exist_ok=True)
        for j, img in enumerate(imgs):
            (out_dir / f"{f.stem}_chunk{start + j}.png").write_bytes(
                write_png_gray(img))
        written += len(imgs)
        timings["png"] += time.perf_counter() - t0
    return written


def build_dataset_df(audio_dir: str = "downloads", save_to_file: bool = True,
                     save_path: str = "downloads/processed_dataset.parquet",
                     chunk_size_sec: float = 3.0,
                     max_duration: Optional[float] = 1800.0,
                     n_mels: int = 128, batch_chunks: int = 64,
                     device="cuda"):
    """The parquet variant: a DataFrame with one row per chunk, columns
    ``spectogram`` (PNG bytes), ``instrument``, ``title`` (the file's
    stem) and ``chunk_id`` (the chunk's first sample), written to
    ``save_path`` when ``save_to_file``.  Needs pandas (and pyarrow or
    fastparquet to write)."""
    try:
        import pandas as pd
    except ImportError as e:
        raise RuntimeError("build_dataset_df needs pandas, which is not "
                           "installed; build the PNG tree with "
                           "build_dataset_folder_structure instead") from e
    ap = AudioProcessor(device=device)
    rows = []
    for f, start, imgs in _file_images(ap, audio_dir, chunk_size_sec,
                                       max_duration, n_mels, batch_chunks,
                                       {}):
        chunk_samples = int(chunk_size_sec * ap.target_sr)
        for j, img in enumerate(imgs):
            rows.append({"spectogram": write_png_gray(img),
                         "instrument": f.parent.name, "title": f.stem,
                         "chunk_id": (start + j) * chunk_samples})
    df = pd.DataFrame(rows, columns=["spectogram", "instrument", "title",
                                     "chunk_id"])
    if save_to_file:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        df.to_parquet(save_path)
    return df
