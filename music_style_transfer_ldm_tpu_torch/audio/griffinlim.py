"""Fast Griffin-Lim phase recovery and mel inversion on the device.

Matches librosa's fast Griffin-Lim (momentum 0.99):

  angles_{k+1} = P(rebuilt_k - m/(1+m) * rebuilt_{k-1}),   P(z) = z/|z|
"""

from __future__ import annotations

import math

import torch

from music_style_transfer_ldm_tpu_torch.audio import mel as _mel
from music_style_transfer_ldm_tpu_torch.audio import nnls as _nnls
from music_style_transfer_ldm_tpu_torch.audio import stft as _stft
from music_style_transfer_ldm_tpu_torch.utils.profiling import span


def griffin_lim(S: torch.Tensor, *, n_iter: int = 32, hop_length: int = 512,
                win_length: int | None = None, n_fft: int | None = None,
                momentum: float = 0.99, init: str = "random", seed: int = 0,
                length: int | None = None,
                init_phase: torch.Tensor | None = None) -> torch.Tensor:
    """Phase-recover audio from magnitudes S [..., n_freq, n_frames].

    init='random' (librosa's default) draws one [n_freq, n_frames] field
    of random phases from a generator seeded by ``seed`` (the counterpart
    of the JAX package's ``key``; the same seed gives the same field) and
    gives it to every item, so an item's audio does not depend on its
    batch.  The JAX package's random phases cannot be reproduced in
    torch; parity tests pass shared angles.  init='zeros' starts from zero
    phase.  init_phase (real angles in radians, overrides init) seeds the
    iteration.
    """
    n_fft = n_fft or 2 * (S.shape[-2] - 1)
    win_length = win_length or n_fft
    S = S.float()
    if init_phase is None:
        if init == "random":
            g = torch.Generator(device=S.device)
            g.manual_seed(int(seed))
            init_phase = torch.rand(S.shape[-2:], generator=g,
                                    device=S.device) * (2.0 * math.pi)
        elif init == "zeros":
            init_phase = torch.zeros(S.shape[-2:], device=S.device)
        else:
            raise ValueError(f"unknown init {init!r}")
    phase = init_phase.float()
    angles = torch.polar(torch.ones_like(phase), phase).expand(S.shape)

    mscale = momentum / (1.0 + momentum)
    rebuilt_prev = torch.zeros(S.shape, dtype=torch.complex64,
                               device=S.device)
    for _ in range(n_iter):
        inverse = _stft.istft(S * angles, n_fft=n_fft, hop_length=hop_length,
                              win_length=win_length)
        rebuilt = _stft.stft(inverse, n_fft=n_fft, hop_length=hop_length,
                             win_length=win_length)
        z = rebuilt - mscale * rebuilt_prev
        angles = z / (z.abs() + 1e-16)
        rebuilt_prev = rebuilt
    return _stft.istft(S * angles, n_fft=n_fft, hop_length=hop_length,
                       win_length=win_length, length=length)


def mel_to_stft(M: torch.Tensor, sr: int = 22050, n_fft: int = 2048,
                power: float = 2.0, nnls_iters: int = 64,
                fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """Linear-frequency magnitudes from mel power [..., n_mels, T]:
    NNLS, then ** (1/power)."""
    fb = _mel.mel_filterbank_np(int(sr), int(n_fft), int(M.shape[-2]),
                                float(fmin), fmax)
    return torch.pow(_nnls.nnls(fb, M, n_iter=nnls_iters), 1.0 / power)


def mel_to_audio(M: torch.Tensor, sr: int = 22050, n_fft: int = 2048,
                 hop_length: int = 512, win_length: int | None = None,
                 power: float = 2.0, n_iter: int = 32, nnls_iters: int = 64,
                 length: int | None = None, seed: int = 0,
                 init_phase: torch.Tensor | None = None) -> torch.Tensor:
    """librosa.feature.inverse.mel_to_audio: [..., n_mels, T] mel power
    -> [..., n_samples] audio; ``seed`` seeds Griffin-Lim's random
    phases.  Traced as ``audio.nnls`` and ``audio.griffin_lim``, on the
    device too."""
    with span("audio.nnls", device=M.device):
        S = mel_to_stft(M, sr=sr, n_fft=n_fft, power=power,
                        nnls_iters=nnls_iters)
    with span("audio.griffin_lim", device=M.device):
        return griffin_lim(S, n_iter=n_iter, hop_length=hop_length,
                           win_length=win_length, n_fft=n_fft,
                           length=length, seed=seed, init_phase=init_phase)
