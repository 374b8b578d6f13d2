"""The port's audio inverse (STFT/ISTFT, mel filterbank, dB, NNLS,
Griffin-Lim) against the JAX package on seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.audio import griffinlim as jgl
from music_style_transfer_ldm_tpu.audio import mel as jmel
from music_style_transfer_ldm_tpu.audio import nnls as jnnls
from music_style_transfer_ldm_tpu.audio import quantize as jq
from music_style_transfer_ldm_tpu.audio import stft as jstft
from music_style_transfer_ldm_tpu_torch.audio import griffinlim, mel, nnls
from music_style_transfer_ldm_tpu_torch.audio import quantize, stft

STFT_ATOL = 1e-4     # f32 FFTs of a unit-scale 0.5 s signal
FB_ATOL = 1e-6       # same float64 construction, cast to f32
DB_ATOL = 1e-6       # elementwise f32
NNLS_RTOL = 1e-4     # 64 FISTA iterations, f32 matmul sum order
GL_ATOL_REL = 1e-3   # x peak |audio|; 4 iterations, f32 FFT order


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def signal():
    rng = np.random.RandomState(0)
    t = np.arange(11025) / 22050.0
    y = (0.5 * np.sin(2 * np.pi * 440.0 * t)[None]
         + 0.1 * rng.randn(2, t.size))
    return y.astype(np.float32)


def test_stft_matches_jax(signal):
    want = np.asarray(jstft.stft(jnp.asarray(signal)))
    got = stft.stft(torch.tensor(signal)).numpy()
    assert got.shape == want.shape == (2, 1025, 22)
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)


@pytest.mark.parametrize("length", [None, 11025, 12000])
def test_istft_matches_jax(signal, length):
    spec = np.asarray(jstft.stft(jnp.asarray(signal)))
    want = np.asarray(jstft.istft(jnp.asarray(spec), length=length))
    got = stft.istft(torch.tensor(spec), length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)


def test_istft_hop_not_dividing_n_fft(signal):
    spec = np.asarray(jstft.stft(jnp.asarray(signal), n_fft=512,
                                 hop_length=200))
    want = np.asarray(jstft.istft(jnp.asarray(spec), hop_length=200))
    got = stft.istft(torch.tensor(spec), hop_length=200).numpy()
    np.testing.assert_allclose(got, want, atol=STFT_ATOL)


def test_filterbank_matches_jax():
    want = jmel._mel_filterbank_np(22050, 2048, 128, 0.0, 11025.0, False,
                                   "slaney")
    got = mel.mel_filterbank_np(22050, 2048, 128, 0.0, None)
    assert got.shape == (128, 1025) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=FB_ATOL)


def test_db_inverse_matches_jax():
    img = np.random.RandomState(1).rand(2, 128, 128).astype(np.float32)
    db_want = np.asarray(jq.unit_image_to_db(jnp.asarray(img)))
    db_got = quantize.unit_image_to_db(torch.tensor(img)).numpy()
    np.testing.assert_allclose(db_got, db_want, atol=DB_ATOL)
    np.testing.assert_allclose(
        mel.db_to_power(torch.tensor(db_want)).numpy(),
        np.asarray(jmel.db_to_power(jnp.asarray(db_want))), atol=DB_ATOL)


def _mel_power(seed=2, t=32):
    img = np.random.RandomState(seed).rand(2, 128, t).astype(np.float32)
    return np.asarray(jmel.db_to_power(jq.unit_image_to_db(
        jnp.asarray(img))))


def test_nnls_matches_jax():
    M = _mel_power()
    fb = jmel._mel_filterbank_np(22050, 2048, 128, 0.0, 11025.0, False,
                                 "slaney")
    want = np.asarray(jnnls.nnls(fb, jnp.asarray(M), n_iter=64))
    got = nnls.nnls(fb, torch.tensor(M), n_iter=64).numpy()
    assert got.shape == (2, 1025, 32)
    assert (got >= 0).all()
    np.testing.assert_allclose(got, want, rtol=NNLS_RTOL,
                               atol=NNLS_RTOL * want.max())


def test_griffin_lim_shared_phase_matches_jax():
    M = _mel_power(3)
    S = np.asarray(jgl.mel_to_stft(jnp.asarray(M), nnls_iters=16))
    angles = np.random.RandomState(4).uniform(
        0, 2 * np.pi, S.shape).astype(np.float32)
    want = np.asarray(jgl.griffin_lim(jnp.asarray(S), n_iter=4,
                                      init_phase=jnp.asarray(angles),
                                      length=16000))
    got = griffinlim.griffin_lim(torch.tensor(S), n_iter=4,
                                 init_phase=torch.tensor(angles),
                                 length=16000).numpy()
    assert got.shape == (2, 16000)
    np.testing.assert_allclose(got, want,
                               atol=GL_ATOL_REL * np.abs(want).max())


def test_mel_to_audio_shape_and_batch_independence():
    """Random init shares one phase field across the batch, so an item's
    audio does not depend on its neighbours."""
    M = torch.tensor(_mel_power(5, 128))
    both = griffinlim.mel_to_audio(M, n_iter=2, nnls_iters=4, length=66150)
    one = griffinlim.mel_to_audio(M[1:], n_iter=2, nnls_iters=4,
                                  length=66150)
    assert tuple(both.shape) == (2, 66150)
    assert torch.isfinite(both).all()
    np.testing.assert_allclose(both[1:].numpy(), one.numpy(),
                               atol=1e-5 * float(one.abs().max()))


@pytest.mark.parametrize("length", [16000, None])
def test_griffin_lim_zero_init_matches_jax(length):
    M = _mel_power(6)
    S = np.asarray(jgl.mel_to_stft(jnp.asarray(M), nnls_iters=16))
    want = np.asarray(jgl.griffin_lim(jnp.asarray(S), n_iter=4,
                                      init="zeros", length=length))
    got = griffinlim.griffin_lim(torch.tensor(S), n_iter=4, init="zeros",
                                 length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=GL_ATOL_REL * np.abs(want).max())


def test_griffin_lim_random_init_is_seeded():
    """The random start is one field from ``seed``: seed 0 is the default,
    another seed another field; an unknown init is refused."""
    S = torch.tensor(np.asarray(jgl.mel_to_stft(jnp.asarray(_mel_power(7)),
                                                nnls_iters=8)))
    default = griffinlim.griffin_lim(S, n_iter=2)
    np.testing.assert_array_equal(
        griffinlim.griffin_lim(S, n_iter=2, init="random", seed=0).numpy(),
        default.numpy())
    np.testing.assert_array_equal(
        griffinlim.griffin_lim(S, n_iter=2, seed=3).numpy(),
        griffinlim.griffin_lim(S, n_iter=2, seed=3).numpy())
    other = griffinlim.griffin_lim(S, n_iter=2, seed=3)
    assert np.abs(other.numpy() - default.numpy()).max() > 1e-3
    audio = griffinlim.mel_to_audio(torch.tensor(_mel_power(7)), n_iter=2,
                                    nnls_iters=8, seed=3)
    assert torch.isfinite(audio).all()
    with pytest.raises(ValueError, match="unknown init"):
        griffinlim.griffin_lim(S, n_iter=1, init="ones")
