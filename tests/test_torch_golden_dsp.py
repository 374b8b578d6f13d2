"""The port's DSP codec against the committed golden fixture (CPU).

``tests/data/golden_dsp.npz`` freezes clip -> mel dB -> uint8 image ->
NNLS mel-to-STFT -> Griffin-Lim audio for three synthetic clips, as the
JAX package's codec produced them; ``tests/test_golden_dsp.py`` holds
the JAX codec to it.  This file holds the port's codec to the same
fixture at the same tolerances, stage by stage, each stage fed the
fixture's own input.  Griffin-Lim starts from the JAX codec's random
phase field (``jax.random.uniform(PRNGKey(0), S.shape, 0, 2 pi)``, the
draw of ``audio/griffinlim.py``), passed to the port as ``init_phase``:
the two RNGs differ, so the port's own seed-0 field is not the fixture's.

The uint8 image and Griffin-Lim stages hold at the JAX test's
tolerances everywhere.  The fixture is the JAX codec's own bits, and two
stages meet f32 rounding at their bars:

* mel dB: 1e-3 dB on every element more than 10 dB above the -80 dB
  floor.  Within 10 dB of the floor the fixture itself lies 1.05e-3 dB
  (chord) from a float64 computation of the same mel spectrogram, so
  there the bar is 2e-3 dB (the port: 1.03e-3 and 1.19e-3 at -77.6 and
  -78.5 dB, chord and chirp).
* NNLS: 64 FISTA iterations on an ill-conditioned filterbank carry a
  rounding difference past the JAX tolerance on a few elements; the JAX
  codec does so itself when its input is rescaled by one ulp (10-31
  elements, up to 3.7e-4 of power).  So an element may miss the JAX
  tolerance only within twice that one-ulp spread (``_jax_ulp_spread``,
  computed here), and such elements are at most 1e-3 of the output, the
  image test's flip budget.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.audio import griffinlim as jax_gl
from music_style_transfer_ldm_tpu.audio import mel as jax_mel
from music_style_transfer_ldm_tpu.audio import quantize as jax_quant
from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_stft
from music_style_transfer_ldm_tpu_torch.audio.mel import db_to_power
from music_style_transfer_ldm_tpu_torch.audio.processor import (
    AudioProcessor,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    uint8_image_to_db,
)

FIXTURE = Path(__file__).parent / "data" / "golden_dsp.npz"
CLIPS = ("chord", "chirp", "noise")
# one ulp of f32 up and half an ulp down: the input rescalings of the
# JAX codec's rounding witness
ULP_SCALES = (1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24)
SHARE_BEYOND = 1e-3     # elements that may miss the JAX tolerance


def _jax_ulp_spread(fn, x, ref) -> float:
    """Largest |fn(x * s) - ref| over the one-ulp rescalings s: how far
    the JAX codec's own output moves from the fixture on rounding."""
    return max(float(np.abs(np.asarray(fn(x * np.float32(s))) - ref).max())
               for s in ULP_SCALES)


def _assert_within(got, ref, atol, rtol, spread) -> None:
    """The JAX tolerance on every element but at most SHARE_BEYOND of
    them, and those within twice the JAX codec's one-ulp spread."""
    err = np.abs(got - ref)
    beyond = err > atol + rtol * np.abs(ref)
    assert beyond.mean() <= SHARE_BEYOND, (
        f"{int(beyond.sum())} elements beyond the JAX tolerance")
    if beyond.any():
        assert err[beyond].max() <= 2.0 * spread, (
            f"{err[beyond].max()} beyond twice the JAX codec's one-ulp "
            f"spread {spread}")


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def proc():
    return AudioProcessor(target_sr=22050, device="cpu")


@pytest.mark.parametrize("name", CLIPS)
def test_golden_mel_db(golden, proc, name):
    mel_db = proc.get_mel_spectrogram(golden[f"{name}_clip"],
                                      n_mels=128).numpy()
    ref = golden[f"{name}_mel_db"]
    near_floor = ref <= ref.max() - 70.0
    err = np.abs(mel_db - ref)
    assert err[~near_floor].max() <= 1e-3
    assert err[near_floor].max(initial=0.0) <= 2e-3


@pytest.mark.parametrize("name", CLIPS)
def test_golden_uint8_image(golden, proc, name):
    img = proc.mel_spectrogram_to_grayscale_image(golden[f"{name}_mel_db"])
    ref = golden[f"{name}_img"]
    assert img.dtype == ref.dtype == np.uint8
    # one-level flips at exact 0.5-rounding boundaries only, on at most
    # 1e-3 of the pixels
    diff = np.abs(img.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} pixels moved"


@pytest.mark.parametrize("name", CLIPS)
def test_golden_nnls_stft_power(golden, proc, name):
    mel_power = db_to_power(uint8_image_to_db(
        torch.as_tensor(golden[f"{name}_img"])))
    got = mel_to_stft(mel_power, sr=22050,
                      nnls_iters=proc.nnls_iters).numpy()
    ref = golden[f"{name}_stft_power"]
    jax_power = jax_mel.db_to_power(jax_quant.uint8_image_to_db(
        golden[f"{name}_img"]))
    spread = _jax_ulp_spread(
        lambda m: jax_gl.mel_to_stft(m, sr=22050,
                                     nnls_iters=proc.nnls_iters),
        np.asarray(jax_power), ref)
    # iterative solver: a scale-aware tolerance
    _assert_within(got, ref, 1e-5 * float(ref.max()), 1e-3, spread)


@pytest.mark.parametrize("name", CLIPS)
def test_golden_griffinlim_audio(golden, proc, name):
    phase = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), golden[f"{name}_stft_power"].shape,
        jnp.float32, 0.0, 2.0 * jnp.pi))
    audio = proc.grayscale_mel_spectrogram_image_to_audio(
        golden[f"{name}_img"], length=golden[f"{name}_clip"].size,
        init_phase=phase).numpy()
    ref = golden[f"{name}_audio"]
    assert audio.shape == ref.shape
    # 32 iterations compound float noise: waveform closeness relative to
    # the signal's scale, and spectral closeness
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(audio, ref, atol=5e-3 * scale, rtol=0)
    fa = np.abs(np.fft.rfft(audio))
    fr = np.abs(np.fft.rfft(ref))
    drift = float(np.linalg.norm(fa - fr)) / (float(np.linalg.norm(fr))
                                              + 1e-12)
    assert drift < 1e-2, f"spectral drift {drift:.4f}"
