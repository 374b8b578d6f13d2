"""Riffusion's spectrogram image law and its audio front end, on the
plain path (riffusion/riffusion ``spectrogram_params.py``,
``image_util.py``).

An image row is a mel bin, highest first (the image is flipped
vertically), a column a frame.  From magnitude mel M [n_mels, frames]:

    v = 255 - 255 (M / max M) ** image_power       (image_power 0.25)

and back, from a unit image u = v / 255, with the clip's level lost:

    M = (1 - u) ** (1 / image_power) * max_value    (max_value 30e6)

The front end is a centred STFT (a 4,410-sample periodic Hann window
inside 17,640 points, hop 441), its magnitude, and 512 HTK mels from 0
to 10 kHz without normalisation (``config.riffusion_audio_config``).
Kernel C computes the dB law of the other model, so this runs on plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio import mel as _mel
from music_style_transfer_ldm_tpu_torch.audio import stft as _stft
from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_audio
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    unit_image_to_uint8,
)
from music_style_transfer_ldm_tpu_torch.config import AudioConfig


def filterbank(a: AudioConfig, device=None) -> torch.Tensor:
    """[n_mels, 1 + n_fft // 2] f32 of the configuration."""
    return _mel.mel_filterbank(a.sample_rate, a.n_fft, a.n_mels, a.fmin,
                               a.fmax, a.mel_htk, a.mel_norm, device=device)


def image_to_mel(images: torch.Tensor, a: AudioConfig) -> torch.Tensor:
    """[..., n_mels, frames] unit images -> magnitude mel, f32."""
    v = 1.0 - images.float().flip(-2)
    return torch.pow(v.clamp(min=0.0), 1.0 / a.image_power) * a.max_value


def image_to_audio(images: torch.Tensor, a: AudioConfig,
                   n_iter: int = 32, nnls_iters: int = 64) -> torch.Tensor:
    """[B, n_mels, frames] unit images -> [B, clip_seconds * sr] audio:
    the law read back, NNLS onto the linear magnitudes, Griffin-Lim
    (``griffinlim.mel_to_audio``: CUDA graphs from a shape's second call
    on a card)."""
    return mel_to_audio(
        image_to_mel(images, a), sr=a.sample_rate, n_fft=a.n_fft,
        hop_length=a.hop_length, win_length=a.win_length, power=a.power,
        n_iter=n_iter, nnls_iters=nnls_iters,
        length=int(round(a.clip_seconds * a.sample_rate)), fmin=a.fmin,
        fmax=a.fmax, htk=a.mel_htk, norm=a.mel_norm)


def peak_normalize(audio: np.ndarray, peak: float = 0.99) -> np.ndarray:
    """Audio scaled to ``peak`` (the law drops the level, and the
    inversion reads it back at ``max_value``): what a WAV holds."""
    top = float(np.abs(audio).max()) if audio.size else 0.0
    return audio * (peak / top) if top > 0 else audio


def mel_to_image(mel: torch.Tensor, a: AudioConfig) -> torch.Tensor:
    """Magnitude mel [..., n_mels, frames] -> unit images on the uint8
    grid (what a PNG holds), each clip scaled by its own max."""
    peak = mel.float().amax((-2, -1), keepdim=True).clamp(min=1e-30)
    v = 1.0 - torch.pow(mel.float() / peak, a.image_power)
    return unit_image_to_uint8(v.flip(-2)).float() / 255.0


def waveform_to_mel(y: torch.Tensor, a: AudioConfig) -> torch.Tensor:
    """[..., T] audio -> magnitude mel [..., n_mels, frames]."""
    spec = _stft.stft(y.float(), n_fft=a.n_fft, hop_length=a.hop_length,
                      win_length=a.win_length).abs()
    return torch.matmul(filterbank(a, spec.device), spec)


def waveform_to_unit_images(y: np.ndarray, a: AudioConfig, frames: int,
                            device="cpu") -> torch.Tensor:
    """[B, T] audio -> [B, n_mels, frames] unit images, each clip's first
    ``frames`` frames (zero audio padded on where it is short)."""
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    need = (frames - 1) * a.hop_length
    if y.shape[-1] < need:
        y = torch.nn.functional.pad(y, (0, need - y.shape[-1]))
    return mel_to_image(waveform_to_mel(y, a)[..., :frames], a)


class FrontEnd:
    """The engine's WAV front end for Riffusion (``audio/processor.py``'s
    names, as ``serving/server.py`` calls them): a clip is kept as it is,
    its first ``clip_seconds`` become the content image."""

    def __init__(self, a: AudioConfig, device=None):
        self.a = a
        self.device = device
        self.target_sr = a.sample_rate

    def trim_silence(self, audio) -> np.ndarray:
        return np.asarray(audio, np.float32)

    def clip_to_content_image(self, audio, size: int = 512) -> np.ndarray:
        """Mono audio at ``target_sr`` -> [size, size, 1]: its first
        ``clip_seconds`` (zero-padded) through the front end."""
        n = int(round(self.a.clip_seconds * self.a.sample_rate))
        y = np.asarray(audio, np.float32)[None, :n]
        img = waveform_to_unit_images(y, self.a, size, self.device)
        return img[0, ..., None].cpu().numpy()
