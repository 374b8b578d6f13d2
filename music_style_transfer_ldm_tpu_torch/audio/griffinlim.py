"""Fast Griffin-Lim phase recovery and mel inversion on the device.

Matches librosa's fast Griffin-Lim (momentum 0.99):

  angles_{k+1} = P(rebuilt_k - m/(1+m) * rebuilt_{k-1}),   P(z) = z/|z|

On a card, ``mel_to_audio`` replays a shape's NNLS and Griffin-Lim as
CUDA graphs from its second call on (``audio/graphs.py``).
"""

from __future__ import annotations

import functools
import math

import torch

from music_style_transfer_ldm_tpu_torch.audio import graphs as _graphs
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
    if init_phase is None:
        if init == "random":
            init_phase = _seeded_phase(tuple(S.shape[-2:]), int(seed),
                                       S.device)
        elif init == "zeros":
            init_phase = torch.zeros(S.shape[-2:], device=S.device)
        else:
            raise ValueError(f"unknown init {init!r}")
    return _recover(S, init_phase, n_iter=n_iter, hop_length=hop_length,
                    win_length=win_length or n_fft, n_fft=n_fft,
                    momentum=momentum, length=length)


@functools.lru_cache(maxsize=32)
def _seeded_phase(shape: tuple, seed: int,
                  device: torch.device) -> torch.Tensor:
    """init='random''s field: ``torch.rand`` from a generator seeded by
    ``seed``, times 2 pi, made once per (shape, seed, device); callers
    must not modify it."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    phase = torch.rand(shape, generator=g, device=device) * (2.0 * math.pi)
    if device.type == "cuda":
        # Other streams read it next: let it be whole before it is shared.
        torch.cuda.current_stream(device).synchronize()
    return phase


def _recover(S: torch.Tensor, phase: torch.Tensor, *, n_iter: int,
             hop_length: int, win_length: int, n_fft: int, momentum: float,
             length: int | None) -> torch.Tensor:
    """Griffin-Lim from real initial angles ``phase`` [..., n_freq,
    n_frames] to the audio, cropped or padded to ``length``."""
    S = S.float()
    phase = phase.float()
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



# The default filterbank that mel_to_audio inverts: librosa's, from 0 Hz
# to sr / 2.
_FMIN, _FMAX = 0.0, None


def _magnitudes(fb, M: torch.Tensor, *, power: float,
                nnls_iters: int) -> torch.Tensor:
    return torch.pow(_nnls.nnls(fb, M, n_iter=nnls_iters), 1.0 / power)


def mel_to_stft(M: torch.Tensor, sr: int = 22050, n_fft: int = 2048,
                power: float = 2.0, nnls_iters: int = 64,
                fmin: float = 0.0, fmax: float | None = None) -> torch.Tensor:
    """Linear-frequency magnitudes from mel power [..., n_mels, T]:
    NNLS, then ** (1/power)."""
    fb = _mel.mel_filterbank_np(int(sr), int(n_fft), int(M.shape[-2]),
                                float(fmin), fmax)
    return _magnitudes(fb, M, power=power, nnls_iters=nnls_iters)


def _graph_key(M: torch.Tensor, phase: torch.Tensor, *, sr: int,
               n_fft: int, hop_length: int, win_length: int, power: float,
               n_iter: int, nnls_iters: int, length: int | None,
               mel: tuple = (_FMIN, _FMAX, False, "slaney")) -> tuple:
    """What a captured inversion depends on: the device, the shapes, every
    parameter, the filterbank's scale and norm and its band (``mel``:
    fmin, fmax, htk, norm), the f32 matmul precision and whether
    inference mode is on (its buffers take no copy outside it)."""
    fmin, fmax, htk, norm = mel
    return (M.device, tuple(M.shape), tuple(phase.shape), int(sr),
            int(n_fft), int(hop_length), int(win_length), float(power),
            int(n_iter), int(nnls_iters), length, htk, norm, fmin, fmax,
            torch.get_float32_matmul_precision(),
            torch.is_inference_mode_enabled())


def mel_to_audio(M: torch.Tensor, sr: int = 22050, n_fft: int = 2048,
                 hop_length: int = 512, win_length: int | None = None,
                 power: float = 2.0, n_iter: int = 32, nnls_iters: int = 64,
                 length: int | None = None, seed: int = 0,
                 init_phase: torch.Tensor | None = None, fmin: float = _FMIN,
                 fmax: float | None = _FMAX, htk: bool = False,
                 norm: str | None = "slaney") -> torch.Tensor:
    """librosa.feature.inverse.mel_to_audio: [..., n_mels, T] mel power
    (magnitude at ``power`` 1) -> [..., n_samples] audio; ``seed`` seeds
    Griffin-Lim's random phases.  The filterbank is librosa's with
    (fmin, fmax, htk, norm); the default is the Slaney one from 0 Hz to
    sr / 2.  Traced as ``audio.nnls`` and ``audio.griffin_lim``, on the
    device too.  On a card, from a shape's second call on, the two are
    graph replays (``audio/graphs.py``)."""
    win_length = win_length or n_fft
    n_mels, frames = int(M.shape[-2]), int(M.shape[-1])
    if init_phase is None:
        phase = _seeded_phase((1 + n_fft // 2, frames), int(seed), M.device)
    else:
        phase = init_phase.float()
    mel = (float(fmin), None if fmax is None else float(fmax), bool(htk),
           norm)
    fb = _mel.mel_filterbank_np(int(sr), int(n_fft), n_mels, *mel)
    magnitudes = functools.partial(_magnitudes, fb, power=power,
                                   nnls_iters=nnls_iters)
    recover = functools.partial(_recover, n_iter=n_iter,
                                hop_length=hop_length,
                                win_length=win_length, n_fft=n_fft,
                                momentum=0.99, length=length)

    def constants() -> tuple:
        return (_nnls.device_constants(fb, M.device),
                _stft.device_constants(win_length, n_fft, hop_length,
                                       frames, M.device))

    key = _graph_key(M, phase, sr=sr, n_fft=n_fft, hop_length=hop_length,
                     win_length=win_length, power=power, n_iter=n_iter,
                     nnls_iters=nnls_iters, length=length, mel=mel)
    with _graphs.GRAPHS.route(key, M, phase, magnitudes, recover,
                              constants) as run:
        with span("audio.nnls", device=M.device):
            S = run.magnitudes(M)
        with span("audio.griffin_lim", device=M.device):
            return run.recover(S, phase)
