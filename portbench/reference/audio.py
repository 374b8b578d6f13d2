"""The plain reference of the mel-image to audio inversion that every
served clip goes through: dB -> power -> non-negative least squares onto
the linear spectrum (64 accelerated projected-gradient steps from a
pseudo-inverse start) -> square root -> fast Griffin-Lim (32 iterations,
momentum 0.99, one seeded field of random start phases) -> 3 s of audio.

librosa's conventions: a Slaney mel filterbank with Slaney area
normalisation, a periodic Hann window, centred frames zero-padded by
n_fft / 2, and an inverse STFT normalised by the squared-window sum.
``matmul_tf32`` computes the least-squares products in TF32: the control
of the audio stage, which the configuration states in float32 with TF32
off.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

MAX_DB = 80.0


def _hz_to_mel(f):
    f = np.asanyarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz)
                                               / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asanyarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=4)
def mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """[n_mels, 1 + n_fft // 2] float32 (librosa.filters.mel defaults)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


@contextlib.contextmanager
def _matmul_precision(tf32: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def nnls(B: np.ndarray, M: torch.Tensor, n_iter: int) -> torch.Tensor:
    """argmin_{X >= 0} ||B X - M||: FISTA with step 1 / sigma_max(B)^2
    from the clipped pseudo-inverse solution; M [..., n_mels, T]."""
    L = float(np.linalg.norm(B, 2) ** 2)
    pinv = torch.as_tensor(np.linalg.pinv(B).astype(np.float32),
                           device=M.device)
    Bt = torch.as_tensor(B, device=M.device)
    x = torch.clamp(torch.matmul(pinv, M), min=0.0)
    y = x
    inv_l = float(np.float32(1.0 / L))
    t = np.float32(1.0)
    for _ in range(n_iter):
        grad = torch.matmul(Bt.T, torch.matmul(Bt, y) - M)
        x_new = torch.clamp(y - inv_l * grad, min=0.0)
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        y = x_new + float((t - np.float32(1.0)) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def _window(n_fft: int, device) -> torch.Tensor:
    n = np.arange(n_fft)
    return torch.as_tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft),
                           dtype=torch.float32, device=device)


def stft(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    lead = y.shape[:-1]
    spec = torch.stft(y.reshape(-1, y.shape[-1]), n_fft=n_fft,
                      hop_length=hop, win_length=n_fft,
                      window=_window(n_fft, y.device), center=True,
                      pad_mode="constant", onesided=True, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(spec: torch.Tensor, n_fft: int, hop: int,
          length: int | None = None) -> torch.Tensor:
    nf = spec.shape[-1]
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * _window(n_fft, spec.device)
    out_len = n_fft + hop * (nf - 1)
    lead = frames.shape[:-2]
    y = F.fold(frames.reshape(-1, nf, n_fft).transpose(1, 2),
               output_size=(1, out_len), kernel_size=(1, n_fft),
               stride=(1, hop)).reshape(*lead, out_len)
    w2 = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)) ** 2
    wsum = np.zeros(out_len)
    for i in range(nf):
        wsum[i * hop:i * hop + n_fft] += w2
    wsum = np.where(wsum > 1e-11, wsum, 1.0)
    y = y / torch.as_tensor(wsum, dtype=torch.float32, device=y.device)
    y = y[..., n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        y = y[..., :length] if y.shape[-1] >= length else F.pad(
            y, (0, length - y.shape[-1]))
    return y


def griffin_lim(S: torch.Tensor, n_iter: int, n_fft: int, hop: int,
                length: int, seed: int = 0, momentum: float = 0.99
                ) -> torch.Tensor:
    g = torch.Generator(device=S.device)
    g.manual_seed(int(seed))
    phase = torch.rand(S.shape[-2:], generator=g, device=S.device) * (
        2.0 * math.pi)
    angles = torch.polar(torch.ones_like(phase), phase).expand(S.shape)
    mscale = momentum / (1.0 + momentum)
    prev = torch.zeros(S.shape, dtype=torch.complex64, device=S.device)
    for _ in range(n_iter):
        rebuilt = stft(istft(S * angles, n_fft, hop), n_fft, hop)
        z = rebuilt - mscale * prev
        angles = z / (z.abs() + 1e-16)
        prev = rebuilt
    return istft(S * angles, n_fft, hop, length)


def image_to_audio(images: torch.Tensor, audio: dict,
                   matmul_tf32: bool = False) -> torch.Tensor:
    """[B, 128, 128] unit mel images (mel bins by frames) -> [B, samples]
    audio of ``audio['seconds']`` s."""
    sr, n_fft, hop = audio["sample_rate"], audio["n_fft"], audio["hop_length"]
    power = torch.pow(10.0, 0.1 * (images.float() * MAX_DB - MAX_DB))
    fb = mel_filterbank(sr, n_fft, images.shape[-2])
    with _matmul_precision(matmul_tf32):
        S = torch.pow(nnls(fb, power, audio["nnls_iters"]), 0.5)
    return griffin_lim(S, audio["griffin_lim_iters"], n_fft, hop,
                       int(audio["seconds"] * sr))
