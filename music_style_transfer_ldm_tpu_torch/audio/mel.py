"""Slaney-style mel filterbank and the dB inverse, librosa-compatible.

The filterbank is built once in numpy (Slaney mel scale, Slaney area
normalisation, fmin 0, fmax sr/2); this module keeps its own copy of the
construction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


_F_SP = 200.0 / 3           # Slaney: linear below 1 kHz ...
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0   # ... logarithmic above


def hz_to_mel(frequencies):
    """Hz -> mel on the Slaney scale (librosa htk=False)."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ)
                                          / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def mel_to_hz(mels):
    """Mel -> Hz (inverse of hz_to_mel)."""
    m = np.asanyarray(mels, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    _F_SP * m)


@functools.lru_cache(maxsize=16)
def mel_filterbank_np(sr: int = 22050, n_fft: int = 2048, n_mels: int = 128,
                      fmin: float = 0.0,
                      fmax: float | None = None) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] Slaney-normalised triangular filterbank
    (librosa.filters.mel defaults), float32.  Callers must not modify the
    (cached) result."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def db_to_power(S_db: torch.Tensor, ref: float = 1.0) -> torch.Tensor:
    """librosa.db_to_power: ref * 10 ** (0.1 dB)."""
    return ref * torch.pow(10.0, 0.1 * S_db.float())
