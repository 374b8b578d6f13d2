"""Mel filterbank and dB conversions, librosa-compatible.

The filterbank is built once in numpy (librosa.filters.mel: the Slaney
mel scale and Slaney area normalisation by default, the HTK scale and no
normalisation on request; fmin 0, fmax sr/2); this module keeps its own
copy of the construction.  The dB math is batched PyTorch with
librosa's defaults (``amin=1e-10``, ``top_db=80``) and the
data-dependent ``ref=max`` taken per item.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio import stft as _stft

_AMIN = 1e-10  # librosa power_to_db default amin

_F_SP = 200.0 / 3           # Slaney: linear below 1 kHz ...
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0   # ... logarithmic above


def hz_to_mel(frequencies, htk: bool = False):
    """Hz -> mel on the Slaney scale (librosa htk=False), or the HTK
    scale."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ)
                                          / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def mel_to_hz(mels, htk: bool = False):
    """Mel -> Hz (inverse of hz_to_mel)."""
    m = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


@functools.lru_cache(maxsize=16)
def mel_filterbank_np(sr: int = 22050, n_fft: int = 2048, n_mels: int = 128,
                      fmin: float = 0.0, fmax: float | None = None,
                      htk: bool = False,
                      norm: str | None = "slaney") -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank (librosa.filters.mel),
    float32; ``norm="slaney"`` scales each filter to unit area, None
    leaves peaks of 1.  Callers must not modify the (cached) result."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                                  n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
        weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def mel_filterbank(sr: int = 22050, n_fft: int = 2048, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney",
                   device=None) -> torch.Tensor:
    """``mel_filterbank_np``'s table as a float32 tensor on ``device``."""
    return torch.as_tensor(mel_filterbank_np(
        int(sr), int(n_fft), int(n_mels), float(fmin), fmax, bool(htk),
        norm), device=device)


def db_to_power(S_db: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    """librosa.db_to_power: ref * 10 ** (0.1 dB)."""
    return ref * torch.pow(10.0, 0.1 * S_db.float())


def _per_item_max(S: torch.Tensor, batched: bool) -> torch.Tensor:
    """max over all but the leading batch axis when batched (each item
    keeps its own ref), else over everything."""
    if batched:
        return torch.amax(S, dim=tuple(range(1, S.ndim)), keepdim=True)
    return torch.amax(S)


def power_to_db(S: torch.Tensor, ref=None, amin: float = _AMIN,
                top_db: float | None = 80.0,
                batched: bool = False) -> torch.Tensor:
    """librosa.power_to_db; ref=None is librosa's ref=np.max."""
    S = S.float()
    if ref is None:
        ref = _per_item_max(S, batched)
    ref = torch.as_tensor(ref, dtype=torch.float32, device=S.device)
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        peak = _per_item_max(log_spec, batched)
        log_spec = torch.maximum(log_spec, peak - top_db)
    return log_spec


def amplitude_to_db(S: torch.Tensor, ref=None, amin: float = 1e-5,
                    top_db: float | None = 80.0,
                    batched: bool = False) -> torch.Tensor:
    """librosa.amplitude_to_db = power_to_db(S**2), amin and ref squared."""
    S = torch.abs(S.float())
    if ref is None:
        ref = _per_item_max(S, batched)
    ref = torch.as_tensor(ref, dtype=torch.float32, device=S.device)
    return power_to_db(S ** 2, ref=ref ** 2, amin=amin ** 2, top_db=top_db,
                       batched=batched)


def db_to_amplitude(S_db: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    """librosa.db_to_amplitude."""
    return torch.sqrt(db_to_power(S_db, ref=ref ** 2))


def power_spectrum(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
                   win_length: int | None = None, power: float = 2.0,
                   center: bool = True) -> torch.Tensor:
    """|STFT(y)| ** power: [..., T] -> [..., 1 + n_fft//2, n_frames]."""
    spec = _stft.stft(y, n_fft=n_fft, hop_length=hop_length,
                      win_length=win_length, center=center)
    return torch.abs(spec) ** power


def melspectrogram(y: torch.Tensor, sr: int = 22050, n_fft: int = 2048,
                   hop_length: int = 512, win_length: int | None = None,
                   n_mels: int = 128, fmin: float = 0.0,
                   fmax: float | None = None, power: float = 2.0,
                   center: bool = True) -> torch.Tensor:
    """librosa.feature.melspectrogram: [..., T] -> [..., n_mels, n_frames]
    (f32 product; the front end's kernel is ops/fused_mel_image.py)."""
    mag = power_spectrum(y, n_fft, hop_length, win_length, power, center)
    fb = torch.as_tensor(mel_filterbank_np(int(sr), int(n_fft), int(n_mels),
                                           float(fmin), fmax),
                         device=mag.device)
    return torch.einsum("mf,...ft->...mt", fb, mag)
