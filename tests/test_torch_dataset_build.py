"""The port's dataset ETL and the rest of its AudioProcessor against the
JAX package, on the CPU.

Seeded WAVs (one 22.05 kHz mono, one 44.1 kHz 16-bit stereo, each with
silence at both ends) go through both packages' ``build_dataset_*``;
kernel C runs as its plain version because the tensors lie on the CPU.
"""

import io
import sys

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image
from scipy.io import wavfile

from music_style_transfer_ldm_tpu.audio import griffinlim as jgl
from music_style_transfer_ldm_tpu.audio import mel as jmel
from music_style_transfer_ldm_tpu.audio import quantize as jq
from music_style_transfer_ldm_tpu.audio.processor import (
    AudioProcessor as JaxAudioProcessor,
)
from music_style_transfer_ldm_tpu.data.build_dataset import (
    build_dataset_df as jax_build_df,
)
from music_style_transfer_ldm_tpu.data.build_dataset import (
    build_dataset_folder_structure as jax_build_folder,
)
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.audio import processor as proc_mod
from music_style_transfer_ldm_tpu_torch.audio.processor import AudioProcessor
from music_style_transfer_ldm_tpu_torch.data import build_dataset as bd
from music_style_transfer_ldm_tpu_torch.ops import fused_mel_image as fm
from music_style_transfer_ldm_tpu_torch.utils.png import read_png_gray

# The front end's tolerance (tests/test_torch_frontend.py): summation order
# and log10's last bit move a pixel by at most one /255 step, on at most
# 1e-3 of the pixels.
MAX_STEP = 1          # uint8 levels
FLIP_SHARE = 1e-3
DB_ATOL = 1e-3        # dB, f32 (FFT and sum order; |dB| up to 80)
AUDIO_ATOL = 1e-4     # Griffin-Lim audio from the same phases, f32
SR = 22050


def _signal(rng, sr, seconds, silence=1.0):
    """Tones and noise with ``silence`` seconds of zeros at both ends."""
    t = np.arange(int(seconds * sr)) / sr
    y = (0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t)
         + 0.2 * np.sin(2 * np.pi * rng.uniform(1000, 4000) * t)
         + 0.05 * rng.randn(len(t)))
    pad = np.zeros(int(silence * sr))
    return np.concatenate([pad, y, pad]).astype(np.float32)


def _write_wavs(root, seconds=(9.5, 7.2)):
    """piano/a.wav at 22.05 kHz mono, violin/b.wav at 44.1 kHz stereo."""
    rng = np.random.RandomState(0)
    (root / "piano").mkdir(parents=True)
    (root / "violin").mkdir(parents=True)
    mono = _signal(rng, SR, seconds[0])
    wavfile.write(str(root / "piano" / "a.wav"), SR,
                  (mono * 32767).astype(np.int16))
    left, right = (_signal(rng, 2 * SR, seconds[1]) for _ in range(2))
    stereo = np.stack([left, right], 1)
    wavfile.write(str(root / "violin" / "b.wav"), 2 * SR,
                  (stereo * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def etl(tmp_path_factory):
    """The same WAVs through the JAX ETL and the port's (PNG trees)."""
    root = tmp_path_factory.mktemp("etl")
    _write_wavs(root / "audio")
    n_jax = jax_build_folder(str(root / "audio"), str(root / "jax"))
    n_port = bd.build_dataset_folder_structure(
        str(root / "audio"), str(root / "port"), device="cpu")
    return root, n_jax, n_port


def _tree(root):
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*.png"))}


def _assert_close_images(got, want):
    """At most one uint8 step apart, on at most FLIP_SHARE of pixels."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= MAX_STEP
    assert (diff > 0).mean() <= FLIP_SHARE


def test_folder_etl_matches_jax(etl):
    root, n_jax, n_port = etl
    jax_files, port_files = _tree(root / "jax"), _tree(root / "port")
    assert n_port == n_jax == len(port_files) > 4
    assert list(port_files) == list(jax_files)
    for name, p in port_files.items():
        got = read_png_gray(p.read_bytes())
        want = np.asarray(Image.open(jax_files[name]).convert("L"))
        assert got.shape == (128, 130)
        _assert_close_images(got, want)


@pytest.mark.parametrize("batch_chunks", [1, 3])
def test_batch_chunks_do_not_change_images(etl, tmp_path, batch_chunks):
    root, _, n_port = etl
    n = bd.build_dataset_folder_structure(
        str(root / "audio"), str(tmp_path), batch_chunks=batch_chunks,
        device="cpu")
    assert n == n_port
    for name, p in _tree(root / "port").items():
        assert (tmp_path / name).read_bytes() == p.read_bytes()


def test_etl_timings_and_kernel_c_batches(etl, tmp_path):
    """timings gains each stage; kernel C's wrapper runs once per batch
    of up to batch_chunks chunks of each file."""
    root, _, n_port = etl
    calls = []
    orig = fm.fused_mel_unit_image_reference

    def spy(fb, power, *a, **k):
        calls.append(power.shape[0])
        return orig(fb, power, *a, **k)

    timings = {}
    try:
        fm.fused_mel_unit_image_reference = spy
        n = bd.build_dataset_folder_structure(
            str(root / "audio"), str(tmp_path), batch_chunks=2,
            device="cpu", timings=timings)
    finally:
        fm.fused_mel_unit_image_reference = orig
    assert n == n_port == sum(calls)
    assert max(calls) == 2
    per_file = [len(list((tmp_path / d).glob("*.png")))
                for d in ("piano", "violin")]
    assert len(calls) == sum(-(-k // 2) for k in per_file)
    assert set(timings) == set(bd.STAGES)
    assert all(v >= 0.0 for v in timings.values())


def test_parquet_matches_jax(etl, tmp_path):
    root, _, _ = etl
    want = jax_build_df(str(root / "audio"),
                        save_path=str(tmp_path / "jax.parquet"))
    got = bd.build_dataset_df(str(root / "audio"),
                              save_path=str(tmp_path / "port.parquet"),
                              device="cpu")
    back = pd.read_parquet(tmp_path / "port.parquet")
    for df in (got, back):
        assert list(df.columns) == list(want.columns)
        assert len(df) == len(want)
        for col in ("instrument", "title", "chunk_id"):
            assert df[col].tolist() == want[col].tolist()
        for a, b in zip(df["spectogram"], want["spectogram"]):
            _assert_close_images(
                read_png_gray(a),
                np.asarray(Image.open(io.BytesIO(b)).convert("L")))


def test_parquet_names_pandas_when_missing(etl, monkeypatch):
    root, _, _ = etl
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(RuntimeError, match="pandas"):
        bd.build_dataset_df(str(root / "audio"), device="cpu")


@pytest.mark.parametrize("parquet", [False, True])
def test_cli_build_dataset(etl, tmp_path, capsys, parquet):
    root, _, n_port = etl
    argv = ["build-dataset", "--audio-dir", str(root / "audio"),
            "--device", "cpu"]
    if parquet:
        argv += ["--parquet", str(tmp_path / "d.parquet")]
    else:
        argv += ["--output-root", str(tmp_path / "imgs")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    if parquet:
        assert len(pd.read_parquet(tmp_path / "d.parquet")) == n_port
        assert f"wrote {n_port} rows" in out
    else:
        assert len(_tree(tmp_path / "imgs")) == n_port
        assert "ETL seconds: {" in out
        for name, p in _tree(root / "port").items():
            assert (tmp_path / "imgs" / name).read_bytes() == p.read_bytes()


# ---------------- the rest of AudioProcessor ----------------------------------


@pytest.fixture(scope="module")
def processors():
    return AudioProcessor(device="cpu"), JaxAudioProcessor()


def _waves(seed=3, n=2, seconds=1.5):
    rng = np.random.RandomState(seed)
    return np.stack([_signal(rng, SR, seconds, silence=0.2)
                     for _ in range(n)])


def test_mel_image_codec_matches_jax(processors):
    port, jax_ap = processors
    db = jax_ap.get_mel_spectrogram(_waves(), n_mels=128)
    got = port.mel_spectrogram_to_grayscale_image(np.asarray(db))
    want = jax_ap.mel_spectrogram_to_grayscale_image(db)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)   # same dB in, exact codec
    assert port.mel_spectogram_to_grayscale_image == \
        port.mel_spectrogram_to_grayscale_image
    assert port.get_mel_spectogram == port.get_mel_spectrogram


def test_linear_spectrogram_codec_and_inverse_match_jax(processors):
    port, jax_ap = processors
    waves = _waves(seed=4)
    got_db = port.get_spectrogram(waves)
    want_db = np.asarray(jax_ap.get_spectrogram(waves))
    np.testing.assert_allclose(got_db.numpy(), want_db, atol=DB_ATOL)
    np.testing.assert_allclose(port.get_spectogram(waves[0]).numpy(),
                               want_db[0], atol=DB_ATOL)
    img = jax_ap.spectrogram_to_grayscale_image(want_db)
    np.testing.assert_array_equal(
        port.spectrogram_to_grayscale_image(want_db), img)
    angles = np.random.RandomState(5).uniform(
        0, 2 * np.pi, img.shape[-2:]).astype(np.float32)
    got = port.grayscale_spectrogram_image_to_audio(
        img, n_iter=3, length=waves.shape[-1], init_phase=angles)
    amp = jmel.db_to_amplitude(jq.uint8_image_to_db(jnp.asarray(img)))
    want = jgl.griffin_lim(amp, n_iter=3, hop_length=512,
                           length=waves.shape[-1],
                           init_phase=jnp.asarray(np.broadcast_to(
                               angles, img.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=AUDIO_ATOL)
    assert port.grayscale_spectogram_image_to_audio == \
        port.grayscale_spectrogram_image_to_audio
    assert port.spectogram_to_grayscale_image == \
        port.spectrogram_to_grayscale_image
    assert port.grayscale_mel_spectogram_image_to_audio == \
        port.grayscale_mel_spectrogram_image_to_audio


def test_normalize_audio_and_raw_image_bytes(processors):
    port, jax_ap = processors
    y = _waves(seed=6)[0] * 0.3
    np.testing.assert_array_equal(port.normalize_audio(y, peak=0.9),
                                  jax_ap.normalize_audio(y, peak=0.9))
    silent = np.zeros(8, np.float32)
    np.testing.assert_array_equal(port.normalize_audio(silent), silent)
    img = np.random.RandomState(7).randint(0, 256, (128, 130), np.uint8)
    png = port.get_raw_image_bytes(img)
    np.testing.assert_array_equal(read_png_gray(png), img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(png))),
        np.asarray(Image.open(io.BytesIO(jax_ap.get_raw_image_bytes(img)))))


def test_plots_name_matplotlib_when_missing(processors, monkeypatch):
    port, _ = processors
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        port.plot_audio(np.zeros(8))
    with pytest.raises(RuntimeError, match="matplotlib"):
        port.plot_mel_spectrogram(np.zeros((4, 4)))


def test_plots_write_files(processors, tmp_path):
    pytest.importorskip("matplotlib")
    port, _ = processors
    port.plot_audio(_waves()[0], out_path=tmp_path / "wave.png")
    port.plot_mel_spectrogram(torch.zeros(8, 10), out_path=tmp_path / "m.png")
    assert (tmp_path / "wave.png").stat().st_size > 0
    assert (tmp_path / "m.png").stat().st_size > 0


# ---------------- trim_silence: blocked frames ---------------------------------


def _trim_whole_matrix(y, top_db=20.0, frame_length=2048, hop_length=512):
    """The whole-[frames, frame_length] version the blocked one replaced."""
    pad = frame_length // 2
    yp = np.pad(np.asarray(y, np.float32), (pad, pad))
    nf = 1 + (len(yp) - frame_length) // hop_length
    idx = (np.arange(nf)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    power = np.mean(yp[idx] ** 2, axis=1)
    ref = max(power.max(), 1e-10)
    db = 10.0 * np.log10(np.maximum(power, 1e-10) / ref)
    nonsilent = np.flatnonzero(db > -top_db)
    start = int(nonsilent[0]) * hop_length
    end = min(len(y), (int(nonsilent[-1]) + 1) * hop_length)
    return y[start:end]


@pytest.mark.parametrize("block_frames", [1, 7, 4096])
def test_blocked_trim_equals_whole_matrix_and_jax(processors, block_frames,
                                                  monkeypatch):
    port, jax_ap = processors
    monkeypatch.setattr(proc_mod, "TRIM_BLOCK_FRAMES", block_frames)
    rng = np.random.RandomState(8)
    y = _signal(rng, SR, 4.3, silence=0.7)
    got = port.trim_silence(y)
    want = _trim_whole_matrix(y)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)          # bit for bit
    np.testing.assert_array_equal(got, jax_ap.trim_silence(y))
    assert 0 < len(got) < len(y)                      # it did trim
    assert len(port.trim_silence(np.zeros(0, np.float32))) == 0
