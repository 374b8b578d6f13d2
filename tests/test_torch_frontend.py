"""The port's WAV front end against the JAX package, on the CPU.

The uint8 image codec, the dB math and the mel spectrogram, kernel C's
plain version (against the JAX Pallas kernel in interpret mode and the
JAX chain), the host STFT, WAV I/O and resampling, the AudioProcessor,
chunking and stitching, image loading and the PNG codec.  Inputs are
made with numpy from a seed; the port's wrappers run their plain
versions because the tensors lie on the CPU.
"""

import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from music_style_transfer_ldm_tpu.audio import io as jio
from music_style_transfer_ldm_tpu.audio import mel as jmel
from music_style_transfer_ldm_tpu.audio import quantize as jq
from music_style_transfer_ldm_tpu.audio.processor import (
    AudioProcessor as JaxAudioProcessor,
)
from music_style_transfer_ldm_tpu.audio.processor import (
    crossfade_stitch as jax_stitch,
)
from music_style_transfer_ldm_tpu.audio.stft import stft_np as jax_stft_np
from music_style_transfer_ldm_tpu.data.build_dataset import (
    chunk_audio as jax_chunk_audio,
)
from music_style_transfer_ldm_tpu.datasets.folder import (
    load_image_unit as jax_load_image_unit,
)
from music_style_transfer_ldm_tpu.ops.pallas.fused_mel_image import (
    fused_mel_unit_image as jax_fused_mel,
)
from music_style_transfer_ldm_tpu_torch.audio import io as tio
from music_style_transfer_ldm_tpu_torch.audio import mel as tmel
from music_style_transfer_ldm_tpu_torch.audio import quantize as tq
from music_style_transfer_ldm_tpu_torch.audio.processor import (
    AudioProcessor, crossfade_stitch,
)
from music_style_transfer_ldm_tpu_torch.audio.stft import stft_np
from music_style_transfer_ldm_tpu_torch.data.build_dataset import chunk_audio
from music_style_transfer_ldm_tpu_torch.datasets.folder import (
    load_image_unit,
)
from music_style_transfer_ldm_tpu_torch.ops import fused_mel_image as fm
from music_style_transfer_ldm_tpu_torch.utils.png import (
    read_png_gray, write_png_gray,
)

DB_ATOL = 1e-4                  # dB, f32 (FFT and sum order)
IMG_ATOL = 1.0 / 255.0 + 1e-5   # unit images: at most one grid step
FLIP_SHARE = 1e-3               # share of elements one grid step apart
GRID_ATOL = 1e-4                # |255 x - round(255 x)| on the grid


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_images_close(got, want):
    """Equal up to one-step flips of the /255 grid, on few elements."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=IMG_ATOL)
    assert np.mean(np.abs(got - want) > 0.5 / 255.0) <= FLIP_SHARE
    np.testing.assert_allclose(got * 255.0, np.round(got * 255.0),
                               atol=GRID_ATOL)


@pytest.fixture(scope="module")
def waves():
    """Three 3 s chunks at 22,050 Hz: tones, noise, a quiet tone."""
    rng = np.random.RandomState(3)
    t = np.arange(66150) / 22050.0
    return np.stack([
        0.4 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t),
        0.3 * rng.randn(66150),
        1e-3 * np.sin(2 * np.pi * 1234 * t) * (t > 1.0),
    ]).astype(np.float32)


# ---------------------------------------------------------------------------
# The uint8 codec and the dB math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_db", [80.0, 60.0])
def test_quantize_codec_matches_jax(max_db):
    rng = np.random.RandomState(0)
    db = rng.uniform(-100.0, 5.0, (3, 128, 130)).astype(np.float32)
    u8 = tq.db_to_uint8_image(_t(db), max_db).numpy()
    np.testing.assert_array_equal(u8, np.asarray(jq.db_to_uint8_image(
        jnp.asarray(db), max_db)))
    np.testing.assert_array_equal(
        tq.uint8_image_to_db(_t(u8), max_db).numpy(),
        np.asarray(jq.uint8_image_to_db(jnp.asarray(u8), max_db)))
    for quantize in (True, False):
        np.testing.assert_array_equal(
            tq.db_to_unit_image(_t(db), max_db, quantize).numpy(),
            np.asarray(jq.db_to_unit_image(jnp.asarray(db), max_db,
                                           quantize)))
    x = rng.rand(2, 128, 128).astype(np.float32)
    np.testing.assert_array_equal(
        tq.unit_image_to_uint8(_t(x)).numpy(),
        np.asarray(jq.unit_image_to_uint8(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tq.unit_image_to_db(_t(x), max_db).numpy(),
        np.asarray(jq.unit_image_to_db(jnp.asarray(x), max_db)))


@pytest.mark.parametrize("batched,top_db,ref", [
    (True, 80.0, None), (False, 80.0, None), (True, None, None),
    (False, 60.0, 2.5)])
def test_power_to_db_matches_jax(batched, top_db, ref):
    rng = np.random.RandomState(1)
    S = (np.abs(rng.randn(3, 128, 50)) ** 2).astype(np.float32)
    S[1] *= 1e4
    S[2, :, :5] = 0.0
    got = tmel.power_to_db(_t(S), ref=ref, top_db=top_db, batched=batched)
    want = jmel.power_to_db(jnp.asarray(S), ref=ref, top_db=top_db,
                            batched=batched)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DB_ATOL)


def test_amplitude_db_round_trip_matches_jax():
    rng = np.random.RandomState(2)
    A = rng.randn(2, 64, 40).astype(np.float32)
    got = tmel.amplitude_to_db(_t(A), batched=True)
    want = jmel.amplitude_to_db(jnp.asarray(A), batched=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=DB_ATOL)
    db = rng.uniform(-80, 0, (2, 64, 40)).astype(np.float32)
    np.testing.assert_allclose(
        tmel.db_to_amplitude(_t(db)).numpy(),
        np.asarray(jmel.db_to_amplitude(jnp.asarray(db))), rtol=1e-5)


def test_melspectrogram_matches_jax(waves):
    got = tmel.melspectrogram(_t(waves[:2]), n_mels=128).numpy()
    want = np.asarray(jmel.melspectrogram(jnp.asarray(waves[:2]),
                                          n_mels=128))
    assert got.shape == want.shape == (2, 128, 130)
    # Two FFT implementations round differently, by about 4e-7 of each
    # item's peak power; bins more than 60 dB below the peak are so
    # small that this shows in their dB, so dB is held there only.
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-6 * w.max()
    got_db = tmel.power_to_db(_t(got), batched=True).numpy()
    want_db = np.asarray(jmel.power_to_db(jnp.asarray(want), batched=True))
    loud = want_db > -60.0
    np.testing.assert_allclose(got_db[loud], want_db[loud], atol=DB_ATOL)


# ---------------------------------------------------------------------------
# Kernel C's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_mels,shape,scale", [
    (128, (3, 1025, 130), None), (64, (2, 1025, 50), 1e4)])
def test_mel_image_plain_matches_pallas_and_chain(n_mels, shape, scale):
    rng = np.random.RandomState(42)
    fb = np.asarray(jmel.mel_filterbank(22050, 2048, n_mels))
    S = (np.abs(rng.randn(*shape)) ** 2).astype(np.float32)
    if scale:
        S[1] *= scale                    # items at wildly different scales
    got = fm.fused_mel_unit_image_reference(_t(fb), _t(S)).numpy()
    pallas = np.asarray(jax_fused_mel(jnp.asarray(fb), jnp.asarray(S),
                                      interpret=True))
    mel = np.einsum("mf,bft->bmt", fb, S)
    chain = np.asarray(jq.db_to_unit_image(
        jmel.power_to_db(jnp.asarray(mel), batched=True)))
    assert got.shape == (shape[0], n_mels, shape[2])
    _assert_images_close(got, pallas)
    _assert_images_close(got, chain)
    for item in got:                     # each item keeps its own ref=max
        assert item.max() == 1.0


def test_mel_image_wrapper_routes_cpu_to_plain_version():
    rng = np.random.RandomState(4)
    fb = _t(tmel.mel_filterbank_np(22050, 2048, 128))
    S = _t((np.abs(rng.randn(2, 1025, 130)) ** 2).astype(np.float32))
    before = fm.fused_mel_unit_image.launches
    np.testing.assert_array_equal(
        fm.fused_mel_unit_image(fb, S).numpy(),
        fm.fused_mel_unit_image_reference(fb, S).numpy())
    assert fm.fused_mel_unit_image.launches == before   # no kernel ran
    with pytest.raises(ValueError, match="do not fit"):
        fm.fused_mel_unit_image(fb, S[:, :1024])
    cost = fm.mel_image_cost(128, 1025, 130, 1)
    assert cost["flops"] == 34_112_000
    assert cost["bytes"] == 524_800 + 599_560


@pytest.fixture(scope="module")
def slaney_bands():
    fb = _t(tmel.mel_filterbank_np(22050, 2048, 128))
    return fb, fm.mel_bands(fb).numpy()


def test_mel_bands_cover_every_nonzero(slaney_bands):
    fb, bands = slaney_bands
    assert bands.dtype == np.int32 and bands.shape == (128, 2)
    nz = fb.numpy() != 0
    col = np.arange(fb.shape[1])
    for m, (lo, hi) in enumerate(bands):
        assert nz[m, lo] and nz[m, hi - 1]
        assert not nz[m, (col < lo) | (col >= hi)].any()
    width = bands[:, 1] - bands[:, 0]
    # the Slaney filterbank at 22,050 Hz, n_fft 2048: 4 to 53 bins a row
    assert (width.min(), width.max(), width.sum()) == (4, 53, 2018)
    assert width.sum() == nz.sum()


def test_mel_bands_dense_and_empty_rows():
    rng = np.random.RandomState(2)
    dense = _t(rng.rand(6, 40).astype(np.float32) + 0.1)
    np.testing.assert_array_equal(fm.mel_bands(dense).numpy(),
                                  [[0, 40]] * 6)
    sparse = np.zeros((4, 40), np.float32)
    sparse[1, 7] = 1.0
    sparse[2, 3:9] = 0.5
    sparse[2, 5] = 0.0                      # a zero inside a band
    sparse[3, 39] = np.nan                  # NaN counts as nonzero
    np.testing.assert_array_equal(fm.mel_bands(_t(sparse)).numpy(),
                                  [[0, 0], [7, 8], [3, 9], [39, 40]])


@pytest.mark.parametrize("sr,n_fft,n_mels", [(22050, 2048, 128),
                                              (16000, 1024, 64),
                                              (44100, 2048, 256)])
def test_row_groups_partition_the_rows(sr, n_fft, n_mels):
    fb = _t(tmel.mel_filterbank_np(sr, n_fft, n_mels))
    bands = fm.mel_bands(fb).numpy()
    groups = fm.row_groups(bands)
    assert groups[0, 0] == 0 and groups[-1, 1] == n_mels
    np.testing.assert_array_equal(groups[1:, 0], groups[:-1, 1])
    rows = groups[:, 1] - groups[:, 0]
    assert rows.min() >= 1 and rows.max() <= fm.MAX_ROWS
    width = np.maximum(bands[:, 1] - bands[:, 0], 0)
    cap = -(-int(width.sum()) // fm.GROUP_TARGET)
    for r0, r1, lo, hi in groups:
        live = bands[r0:r1][width[r0:r1] > 0]
        assert lo == live[:, 0].min() and hi == live[:, 1].max()
        # balanced by band width: over the cap only as one row
        assert r1 - r0 == 1 or width[r0:r1].sum() <= cap
    grid = fm.mel_image_grid(fb, 130)
    assert grid["ctas_per_item"] == len(groups)
    assert grid["band_macs"] == width.sum() * 130
    if (sr, n_fft, n_mels) == (22050, 2048, 128):
        # the flagship's grid at B=1 fills >= 64 of 132 SMs
        assert len(groups) >= 64 and grid["band_macs"] == 2018 * 130


def test_mel_image_band_cost(slaney_bands):
    fb, bands = slaney_bands
    # Slaney rows cover bins 1 .. 1023 of 1025
    for B in (1, 8):
        cost = fm.mel_image_band_cost(fb, 130, B)
        assert cost["flops"] == 2 * 2018 * 130 * B
        assert cost["bytes"] == 4 * (2018 + B * (1023 * 130 + 128 * 130))
    dense = _t(np.ones((6, 40), np.float32))
    assert fm.mel_image_band_cost(dense, 7, 2) == fm.mel_image_cost(
        6, 40, 7, 2)


def test_row_groups_with_empty_and_dense_rows():
    bands = np.asarray([[0, 0], [0, 0], [3, 9], [0, 0], [0, 500]], np.int32)
    groups = fm.row_groups(bands)
    assert groups[-1].tolist() == [4, 5, 0, 500]     # the wide row alone
    assert all(g[1] - g[0] >= 1 for g in groups)
    empty = fm.row_groups(np.zeros((30, 2), np.int32))
    assert empty[:, 2:].max() == 0 and empty[:, 1].max() == 30
    assert (empty[:, 1] - empty[:, 0]).max() <= fm.MAX_ROWS


def test_band_limited_sum_equals_the_dense_sum():
    """The kernel's order: each row's products in ascending k from +0,
    its band only.  Outside the band a product is +0, so for finite
    spectra the two sums are equal bit for bit (f32, one rounding per
    op); a NaN outside a row's band no longer reaches that row."""
    rng = np.random.RandomState(9)
    fb = tmel.mel_filterbank_np(8000, 128, 12)
    bands = fm.mel_bands(_t(fb)).numpy()
    S = (rng.randn(65, 7) ** 2).astype(np.float32)
    k = np.arange(65)[None, :]
    in_band = (k >= bands[:, :1]) & (k < bands[:, 1:])
    dense = np.zeros((12, 7), np.float32)
    band = np.zeros((12, 7), np.float32)
    for j in range(65):
        prod = fb[:, j:j + 1] * S[j][None, :]
        dense = dense + prod
        band = np.where(in_band[:, j:j + 1], band + prod, band)
    np.testing.assert_array_equal(band, dense)
    S[0, 3] = np.nan                     # bin 0: in no Slaney band
    assert not in_band[:, 0].any()
    with np.errstate(invalid="ignore"):
        nan_dense = np.einsum("mf,ft->mt", fb, S)
    assert np.isnan(nan_dense[:, 3]).all()
    band = np.zeros((12, 7), np.float32)
    for j in range(65):
        band = np.where(in_band[:, j:j + 1],
                        band + fb[:, j:j + 1] * S[j][None, :], band)
    assert np.isfinite(band).all()


# ---------------------------------------------------------------------------
# Host STFT, WAV I/O, resampling
# ---------------------------------------------------------------------------


def test_stft_np_matches_jax(waves):
    np.testing.assert_array_equal(stft_np(waves[:2]),
                                  jax_stft_np(waves[:2]))
    np.testing.assert_array_equal(stft_np(waves[0], n_fft=1024,
                                          hop_length=256, win_length=800),
                                  jax_stft_np(waves[0], n_fft=1024,
                                              hop_length=256, win_length=800))


@pytest.mark.parametrize("orig_sr", [44100, 48000, 22050, 16000])
def test_resample_matches_jax(orig_sr):
    y = np.random.RandomState(orig_sr).randn(orig_sr // 2).astype(np.float32)
    np.testing.assert_array_equal(tio.resample(y, orig_sr, 22050),
                                  jio.resample(y, orig_sr, 22050))


@pytest.mark.parametrize("mono", [True, False])
def test_wav_write_and_load_match_jax(tmp_path, mono):
    from scipy.io import wavfile
    rng = np.random.RandomState(5)
    stereo = (0.5 * rng.randn(44100, 2)).astype(np.float32)
    path = tmp_path / "in.wav"
    wavfile.write(path, 44100, (np.clip(stereo, -1, 1) * 32767)
                  .astype(np.int16))
    got, sr = tio.load_audio(path, sr=22050, mono=mono)
    want, want_sr = jio.load_audio(path, sr=22050, mono=mono)
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    a, b = io.BytesIO(), io.BytesIO()
    tio.write_wav(a, got, 22050)
    jio.write_wav(b, want, 22050)
    assert a.getvalue() == b.getvalue()


def test_non_wav_without_ffmpeg_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(tio, "have_ffmpeg", lambda: False)
    with pytest.raises(RuntimeError, match="without ffmpeg"):
        tio.load_audio(tmp_path / "clip.mp3")


# ---------------------------------------------------------------------------
# AudioProcessor, chunking, stitching
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def processors():
    return AudioProcessor(device="cpu"), JaxAudioProcessor()


def test_processor_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AudioProcessor()


def test_waveform_batch_to_unit_images_matches_jax(processors, waves):
    ap, jap = processors
    got = ap.waveform_batch_to_unit_images(waves)
    want = jap.waveform_batch_to_unit_images(jnp.asarray(waves))
    assert tuple(got.shape) == (3, 128, 130)
    _assert_images_close(got.numpy(), want)


def test_get_mel_spectrogram_matches_jax(processors, waves):
    ap, jap = processors
    got = ap.get_mel_spectrogram(waves[:2], n_mels=128).numpy()
    want = np.asarray(jap.get_mel_spectrogram(jnp.asarray(waves[:2]),
                                              n_mels=128))
    loud = want > -60.0      # as in test_melspectrogram_matches_jax
    np.testing.assert_allclose(got[loud], want[loud], atol=DB_ATOL)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("lead,tail", [(0.5, 0.25), (0.0, 0.0), (1.2, 0.0)])
def test_trim_and_content_image_match_jax(processors, lead, tail):
    ap, jap = processors
    rng = np.random.RandomState(6)
    sr = 22050
    tone = 0.3 * np.sin(2 * np.pi * 330 * np.arange(2 * sr) / sr)
    y = np.concatenate([1e-5 * rng.randn(int(lead * sr)), tone,
                        1e-5 * rng.randn(int(tail * sr))]).astype(np.float32)
    trimmed = ap.trim_silence(y)
    np.testing.assert_array_equal(trimmed, jap.trim_silence(y))
    got = ap.clip_to_content_image(trimmed)
    assert got.shape == (128, 128, 1) and got.dtype == np.float32
    _assert_images_close(got, jap.clip_to_content_image(trimmed))


@pytest.mark.parametrize("n,hop_s,max_dur", [
    (9 * 22050, None, 1800.0), (9 * 22050 - 1000, 1.5, None),
    (2 * 22050, 1.5, None), (10, None, None), (20 * 22050, 2.0, 7.0)])
def test_chunk_audio_matches_jax(n, hop_s, max_dur):
    y = np.random.RandomState(n).randn(n).astype(np.float32)
    np.testing.assert_array_equal(
        chunk_audio(y, 22050, 3.0, max_dur, hop_seconds=hop_s),
        jax_chunk_audio(y, 22050, 3.0, max_dur, hop_seconds=hop_s))


@pytest.mark.parametrize("n,hop", [(4, 33075), (3, 66150), (1, 1000),
                                   (5, 16537)])
def test_crossfade_stitch_matches_jax(n, hop):
    chunks = np.random.RandomState(n).randn(n, 66150).astype(np.float32)
    np.testing.assert_array_equal(crossfade_stitch(chunks, hop),
                                  jax_stitch(chunks, hop))


def test_crossfade_stitch_refuses_gaps():
    with pytest.raises(ValueError, match="misalign"):
        crossfade_stitch(np.zeros((2, 100), np.float32), 150)


# ---------------------------------------------------------------------------
# Images: load_image_unit and the PNG codec (against Pillow)
# ---------------------------------------------------------------------------


def _png_with_filter(img: np.ndarray, ftype: int, ctype: int) -> bytes:
    """Encode uint8 [H, W, C] with one filter type on every row."""
    h, w, ch = img.shape
    stride = w * ch
    data = img.reshape(h, stride).astype(np.int64)
    rows = []
    for y in range(h):
        cur = data[y]
        up = data[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(ch, np.int64), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int64), up[:-ch]])
        if ftype == 0:
            pred = np.zeros(stride, np.int64)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = up
        elif ftype == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
        rows.append(bytes([ftype]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype,ch", [(0, 1), (2, 3), (6, 4)])
def test_png_reader_matches_pillow(ftype, ctype, ch):
    img = np.random.RandomState(ftype * 10 + ch).randint(
        0, 256, (21, 37, ch)).astype(np.uint8)
    data = _png_with_filter(img, ftype, ctype)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    np.testing.assert_array_equal(read_png_gray(data), want)


def test_png_writer_round_trips_through_pillow(tmp_path):
    img = np.random.RandomState(8).randint(0, 256, (128, 390)).astype(
        np.uint8)
    data = write_png_gray(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  img)
    np.testing.assert_array_equal(read_png_gray(data), img)
    # Pillow's own encoder (its choice of filters) reads back the same.
    buf = io.BytesIO()
    Image.fromarray(img, mode="L").save(buf, format="PNG")
    np.testing.assert_array_equal(read_png_gray(buf.getvalue()), img)
    # ... and load_image_unit crops and pads as the JAX package's does.
    for shape in ((128, 390), (100, 60)):
        path = tmp_path / f"img{shape[0]}.png"
        path.write_bytes(write_png_gray(img[:shape[0], :shape[1]]))
        np.testing.assert_array_equal(load_image_unit(path),
                                      jax_load_image_unit(path))


def test_png_reader_refuses_what_it_cannot_read():
    img = np.zeros((4, 4, 1), np.uint8)
    data = _png_with_filter(img, 0, 0)
    with pytest.raises(ValueError, match="not a PNG"):
        read_png_gray(b"GIF89a" + data[6:])
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png_gray(buf.getvalue())
