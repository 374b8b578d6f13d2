"""The audio front end and back end around the model.

``AudioProcessor`` turns audio into the model's [0, 1] mel images and
images back into audio.  File decode, resampling and silence trimming
are host numpy (their output lengths depend on the data); everything
after that is batched PyTorch on the processor's device.  On the card,
``waveform_batch_to_unit_images`` is ``torch.stft`` power spectra
followed by kernel C (``ops/fused_mel_image.py``).

Shapes: waveforms [..., T]; spectrograms and images [..., n_mels, frames]
(rows are mel bins, columns frames).
"""

from __future__ import annotations

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.audio import io as audio_io
from music_style_transfer_ldm_tpu_torch.audio import mel as _mel
from music_style_transfer_ldm_tpu_torch.audio import quantize as _quant
from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_audio
from music_style_transfer_ldm_tpu_torch.ops.fused_mel_image import (
    fused_mel_unit_image,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device


class AudioProcessor:
    """Audio <-> mel image on one device (default the card; raises
    without one unless ``device="cpu"`` is asked for)."""

    def __init__(self, target_sr: int = 22050, n_fft: int = 2048,
                 hop_length: int = 512, nnls_iters: int = 64,
                 device="cuda"):
        self.target_sr = target_sr
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.nnls_iters = nnls_iters
        self.device = resolve_device(device)
        self._fb: dict = {}

    # ---------------- host side (file decode, data-dependent lengths) ---

    def load_audio(self, filepath) -> tuple[np.ndarray, int]:
        """Mono float32 at ``target_sr``."""
        return audio_io.load_audio(filepath, sr=self.target_sr)

    def trim_silence(self, audio: np.ndarray, top_db: float = 20.0,
                     frame_length: int = 2048, hop_length: int = 512
                     ) -> np.ndarray:
        """Trim leading and trailing frames more than ``top_db`` below the
        loudest (librosa.effects.trim)."""
        y = np.asarray(audio, np.float32)
        if y.size == 0:
            return y
        pad = frame_length // 2
        yp = np.pad(y, (pad, pad))
        nf = 1 + (len(yp) - frame_length) // hop_length
        idx = (np.arange(nf)[:, None] * hop_length
               + np.arange(frame_length)[None, :])
        power = np.mean(yp[idx] ** 2, axis=1)  # rms**2 per frame
        ref = max(power.max(), 1e-10)
        db = 10.0 * np.log10(np.maximum(power, 1e-10) / ref)
        nonsilent = np.flatnonzero(db > -top_db)
        if nonsilent.size == 0:
            return y[:0]
        start = int(nonsilent[0]) * hop_length
        end = min(len(y), (int(nonsilent[-1]) + 1) * hop_length)
        return y[start:end]

    # ---------------- device side (batched) -----------------------------

    def _as_device(self, x, dtype=torch.float32) -> torch.Tensor:
        """numpy or tensor -> a tensor of ``dtype`` on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def filterbank(self, n_mels: int = 128) -> torch.Tensor:
        """[n_mels, 1 + n_fft//2] Slaney filterbank on the device."""
        if n_mels not in self._fb:
            self._fb[n_mels] = torch.as_tensor(
                _mel.mel_filterbank_np(self.target_sr, self.n_fft, n_mels),
                device=self.device)
        return self._fb[n_mels]

    def get_mel_spectrogram(self, audio, sr: int | None = None,
                            n_mels: int = 256) -> torch.Tensor:
        """Log-mel dB with per-item ref=max: [..., T] -> [..., n_mels, F]."""
        y = self._as_device(audio)
        mel_power = _mel.melspectrogram(
            y, sr=sr or self.target_sr, n_fft=self.n_fft,
            hop_length=self.hop_length, n_mels=n_mels)
        return _mel.power_to_db(mel_power, batched=y.ndim > 1)

    def waveform_batch_to_unit_images(self, chunks, n_mels: int = 128,
                                      max_db: float = 80.0) -> torch.Tensor:
        """[B, T] audio chunks -> [B, n_mels, F] images in [0, 1] on the
        uint8 grid (what a PNG round trip gives): power spectra, then
        kernel C."""
        y = self._as_device(chunks)
        power = _mel.power_spectrum(y, n_fft=self.n_fft,
                                    hop_length=self.hop_length)
        return fused_mel_unit_image(self.filterbank(n_mels), power,
                                    max_db=max_db)

    def clip_to_content_image(self, audio, n_mels: int = 128,
                              size: int = 128) -> np.ndarray:
        """First 3 s of a clip (zero-padded) -> [size, size, 1] image: the
        whole chunk's frames set the dB reference, then the first
        ``size`` frames are kept."""
        chunk = int(3 * self.target_sr)
        piece = np.zeros(chunk, np.float32)
        n = min(len(audio), chunk)
        piece[:n] = np.asarray(audio, np.float32)[:chunk]
        img = self.waveform_batch_to_unit_images(piece[None], n_mels=n_mels)
        return img[0, :, :size, None].cpu().numpy().astype(np.float32)

    def grayscale_mel_spectrogram_image_to_audio(
            self, image, sr: int | None = None, max_db: float = 80.0,
            n_iter: int = 32, length: int | None = None,
            init_phase=None) -> torch.Tensor:
        """uint8 image [..., n_mels, F] -> dB -> power -> NNLS and
        Griffin-Lim audio on the device.  ``init_phase`` (real angles,
        [..., 1 + n_fft//2, F]) seeds Griffin-Lim; without it every item
        starts from the same seed-0 random phases."""
        img = self._as_device(image, torch.uint8)
        mel_power = _mel.db_to_power(_quant.uint8_image_to_db(img, max_db))
        if init_phase is not None:
            init_phase = self._as_device(init_phase)
        return mel_to_audio(mel_power, sr=sr or self.target_sr,
                            n_fft=self.n_fft, hop_length=self.hop_length,
                            n_iter=n_iter, nnls_iters=self.nnls_iters,
                            length=length, init_phase=init_phase)


def crossfade_stitch(chunks: np.ndarray, hop_samples: int) -> np.ndarray:
    """Stitch overlapping reconstructed chunks into one waveform.

    chunks: [N, L] windows taken at stride hop_samples (<= L); overlaps
    are blended with complementary linear ramps (equal-gain crossfade).
    hop_samples == L is plain concatenation."""
    chunks = np.asarray(chunks, np.float32)
    n, length = chunks.shape
    hop = int(hop_samples)
    if hop > length and n > 1:
        raise ValueError(
            f"hop_samples ({hop}) > chunk length ({length}): windows do "
            f"not cover the signal, stitching would misalign time")
    if hop >= length or n == 1:
        return chunks.reshape(-1)[: (n - 1) * hop + length]
    total = (n - 1) * hop + length
    out = np.zeros(total, np.float32)
    norm = np.zeros(total, np.float32)
    overlap = length - hop
    ramp_in = np.ones(length, np.float32)
    ramp_in[:overlap] = np.linspace(0.0, 1.0, overlap, endpoint=False)
    ramp_out = np.ones(length, np.float32)
    ramp_out[hop:] = np.linspace(1.0, 0.0, overlap, endpoint=False)
    for j in range(n):
        w = np.ones(length, np.float32)
        if j > 0:
            w = w * ramp_in
        if j < n - 1:
            w = w * ramp_out
        out[j * hop:j * hop + length] += w * chunks[j]
        norm[j * hop:j * hop + length] += w
    return out / np.maximum(norm, 1e-8)
