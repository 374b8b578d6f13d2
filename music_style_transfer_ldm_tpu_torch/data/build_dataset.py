"""Audio -> fixed-length chunks, as the dataset ETL cuts them.

Only ``chunk_audio`` is ported so far: the CLI's transfer path cuts a
clip into 3 s model inputs with it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
