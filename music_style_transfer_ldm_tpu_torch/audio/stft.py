"""Batched STFT / ISTFT in PyTorch, matching librosa conventions.

* periodic Hann window of ``win_length``, zero-padded centred inside
  ``n_fft``;
* ``center=True`` pads the signal by ``n_fft // 2`` on both sides with
  ZEROS (librosa >= 0.10 ``pad_mode='constant'``; torch.stft's default
  is 'reflect', so the mode is passed explicitly);
* the ISTFT overlap-adds windowed frames, divides by the squared-window
  sum (NOLA), trims the centre padding and pads or cuts to ``length``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hann_np(win_length: int) -> np.ndarray:
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def hann_window(win_length: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """Periodic Hann window, identical to scipy.signal.get_window('hann',
    N)."""
    return torch.as_tensor(_hann_np(win_length), dtype=dtype, device=device)


def _padded_window_np(win_length: int, n_fft: int) -> np.ndarray:
    """Window centred in an n_fft-long buffer (librosa util.pad_center)."""
    if win_length > n_fft:
        raise ValueError(f"win_length={win_length} > n_fft={n_fft}")
    w = _hann_np(win_length)
    lpad = (n_fft - win_length) // 2
    return np.pad(w, (lpad, n_fft - win_length - lpad))


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    return torch.as_tensor(_padded_window_np(win_length, n_fft),
                           dtype=torch.float32, device=device)


def num_frames(n_samples: int, n_fft: int, hop_length: int,
               center: bool = True) -> int:
    """Number of STFT frames librosa produces for n_samples."""
    if center:
        n_samples = n_samples + 2 * (n_fft // 2)
    return 1 + (n_samples - n_fft) // hop_length


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """[..., T] -> [..., n_frames, n_fft] frames; with ``center`` the
    signal is zero-padded by n_fft // 2 on both sides first."""
    if center:
        y = F.pad(y, (n_fft // 2, n_fft // 2))
    return y.unfold(-1, n_fft, hop_length)


def stft(y: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         win_length: int | None = None, center: bool = True) -> torch.Tensor:
    """Complex STFT: [..., T] -> [..., 1 + n_fft//2, n_frames]."""
    win_length = win_length or n_fft
    lead = y.shape[:-1]
    spec = torch.stft(y.float().reshape(-1, y.shape[-1]), n_fft=n_fft,
                      hop_length=hop_length, win_length=n_fft,
                      window=_window(win_length, n_fft, y.device),
                      center=center, pad_mode="constant", normalized=False,
                      onesided=True, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def stft_np(y: np.ndarray, n_fft: int = 2048, hop_length: int = 512,
            win_length: int | None = None, center: bool = True
            ) -> np.ndarray:
    """Host numpy STFT (same window, padding and layout as ``stft``):
    [..., T] -> [..., 1 + n_fft//2, n_frames] complex.  Used where the
    phases are wanted on the host, e.g. ``cli transfer --phase-init
    content``."""
    win_length = win_length or n_fft
    window = _padded_window_np(win_length, n_fft)
    y = np.asarray(y, np.float32)
    if center:
        pad = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
        y = np.pad(y, pad)
    nf = 1 + (y.shape[-1] - n_fft) // hop_length
    idx = np.arange(nf)[:, None] * hop_length + np.arange(n_fft)[None, :]
    spec = np.fft.rfft(y[..., idx] * window, n=n_fft, axis=-1)
    return np.swapaxes(spec, -1, -2)


@functools.lru_cache(maxsize=16)
def _window_sum_np(win_length: int, n_fft: int, hop_length: int,
                   nf: int) -> np.ndarray:
    w2 = _padded_window_np(win_length, n_fft) ** 2
    wsum = np.zeros(n_fft + hop_length * (nf - 1))
    for t in range(nf):
        wsum[t * hop_length:t * hop_length + n_fft] += w2
    return np.where(wsum > 1e-11, wsum, 1.0)  # librosa util.tiny threshold


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[..., n_frames, n_fft] -> [..., n_fft + hop*(n_frames-1)]: each
    output sample sums its frames in a fixed order (no atomics)."""
    n_fft, nf = frames.shape[-1], frames.shape[-2]
    lead = frames.shape[:-2]
    out_len = n_fft + hop_length * (nf - 1)
    cols = frames.reshape(-1, nf, n_fft).transpose(1, 2)  # [N, n_fft, nf]
    y = F.fold(cols, output_size=(1, out_len), kernel_size=(1, n_fft),
               stride=(1, hop_length))
    return y.reshape(*lead, out_len)


def istft(spec: torch.Tensor, n_fft: int | None = None,
          hop_length: int = 512, win_length: int | None = None,
          center: bool = True, length: int | None = None) -> torch.Tensor:
    """Inverse STFT with NOLA normalisation: [..., n_freq, n_frames]
    complex -> [..., n_samples] f32."""
    n_fft = n_fft or 2 * (spec.shape[-2] - 1)
    win_length = win_length or n_fft
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    y = _overlap_add(frames * _window(win_length, n_fft, spec.device),
                     hop_length)
    wsum = _window_sum_np(win_length, n_fft, hop_length, spec.shape[-1])
    y = y / torch.as_tensor(wsum, dtype=torch.float32, device=y.device)
    if center:
        half = n_fft // 2
        y = y[..., half:y.shape[-1] - half]
    if length is not None:
        if y.shape[-1] >= length:
            y = y[..., :length]
        else:
            y = F.pad(y, (0, length - y.shape[-1]))
    return y
