"""Host-side audio file I/O.

WAV is read and written with scipy; anything else (mp3, m4a, ...) is
decoded by an ``ffmpeg`` subprocess when the binary is present.
Resampling is polyphase filtering (scipy.signal.resample_poly).  Mono is
the mean over channels (librosa's to_mono).
"""

from __future__ import annotations

import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def _to_float_mono(data: np.ndarray) -> np.ndarray:
    y = _to_float(data)
    if y.ndim == 2:  # [T, C] -> mono mix
        y = y.mean(axis=1)
    return y


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return y.astype(np.float32)
    g = math.gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path: str | Path, sr: int = 22050, mono: bool = True
               ) -> tuple[np.ndarray, int]:
    """Load an audio file as float32 at the target sample rate: [T] when
    mono, else [T, C]."""
    path = Path(path)
    if path.suffix.lower() == ".wav":
        orig_sr, data = wavfile.read(str(path))
        if mono:
            y = _to_float_mono(data)
            return resample(y, int(orig_sr), sr), sr
        y = _to_float(data)
        if y.ndim == 1:
            return resample(y, int(orig_sr), sr), sr
        chans = [resample(y[:, c], int(orig_sr), sr)
                 for c in range(y.shape[1])]
        return np.stack(chans, axis=1), sr
    if not have_ffmpeg():
        raise RuntimeError(
            f"Cannot decode {path.suffix} without ffmpeg; install ffmpeg or "
            "provide WAV input.")
    cmd = ["ffmpeg", "-v", "error", "-i", str(path), "-f", "f32le",
           "-acodec", "pcm_f32le", "-ar", str(sr)]
    n_channels = 1
    if mono:
        cmd += ["-ac", "1"]
    else:
        n_channels = _probe_channels(path)
    cmd += ["-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    y = np.frombuffer(out, dtype=np.float32).copy()
    if n_channels > 1:
        y = y.reshape(-1, n_channels)  # de-interleave to [T, C]
    return y, sr


def _probe_channels(path) -> int:
    """Channel count via ffprobe (to de-interleave raw ffmpeg PCM)."""
    if shutil.which("ffprobe") is None:
        raise RuntimeError(
            "mono=False on non-WAV input requires ffprobe to determine the "
            "channel count")
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=channels", "-of", "csv=p=0", str(path)],
        capture_output=True, check=True).stdout
    return int(out.strip() or 1)


def write_wav(path, y: np.ndarray, sr: int = 22050) -> None:
    """Write float32 audio to a 16-bit PCM WAV file (path or file-like)."""
    y = np.clip(np.asarray(y, np.float32), -1.0, 1.0)
    target = str(path) if isinstance(path, (str, Path)) else path
    wavfile.write(target, sr, (y * 32767.0).astype(np.int16))
