"""The port's acquisition path (downloader, Hugging Face source, .env
loader, ``cli download``) against the JAX package, on the CPU.

Neither yt-dlp nor the network is here: the downloader runs against a
fake ``yt_dlp`` module (the JAX suite's ``tests/test_ingestion.py``
``_FakeYDL``) and the Hugging Face source against fake ``datasets`` and
``huggingface_hub`` modules, each driving the real code.
"""

import importlib.util
import os
import sys
import types
from pathlib import Path

import pytest

from music_style_transfer_ldm_tpu.data.downloader import (
    AudioDownloader as JaxDownloader,
)
from music_style_transfer_ldm_tpu.utils.env import get_env as jax_get_env
from music_style_transfer_ldm_tpu.utils.env import (
    load_env_file as jax_load_env_file,
)
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.data import hf_utils
from music_style_transfer_ldm_tpu_torch.data.downloader import AudioDownloader
from music_style_transfer_ldm_tpu_torch.utils.env import get_env, load_env_file


class _FakeYDL:
    """Stands in for yt_dlp.YoutubeDL: records options and URLs, writes a
    fake output file on success, raises on demand."""

    calls: list = []           # (opts, urls) per download() call
    fail_urls: dict = {}       # url -> times to fail before succeeding

    def __init__(self, opts):
        self.opts = opts

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def download(self, urls):
        _FakeYDL.calls.append((self.opts, list(urls)))
        for url in urls:
            remaining = _FakeYDL.fail_urls.get(url, 0)
            if remaining:
                _FakeYDL.fail_urls[url] = remaining - 1
                raise RuntimeError(f"simulated extractor error for {url}")
            out = self.opts["outtmpl"].replace("%(title)s", "faketitle")
            out = out.replace(
                "%(ext)s", self.opts["postprocessors"][0]["preferredcodec"])
            Path(out).parent.mkdir(parents=True, exist_ok=True)
            Path(out).write_bytes(b"ID3 fake mp3 payload")


@pytest.fixture()
def fake_ytdlp(monkeypatch):
    mod = types.ModuleType("yt_dlp")
    mod.YoutubeDL = _FakeYDL
    _FakeYDL.calls = []
    _FakeYDL.fail_urls = {}
    monkeypatch.setitem(sys.modules, "yt_dlp", mod)
    return mod


def test_download_options_and_layout_match_jax(fake_ytdlp, tmp_path):
    opts = {}
    for name, cls in (("port", AudioDownloader), ("jax", JaxDownloader)):
        _FakeYDL.calls = []
        dl = cls(output_dir=str(tmp_path / name), audio_format="mp3")
        out_dir = dl.download_audio("https://yt/watch?v=1",
                                    instrument="piano", title="moonlight")
        assert out_dir == tmp_path / name / "piano"
        assert (out_dir / "moonlight.mp3").read_bytes().startswith(b"ID3")
        (opts[name], urls), = _FakeYDL.calls
        assert urls == ["https://yt/watch?v=1"] and dl.failures == []
    assert opts["port"]["outtmpl"].startswith(str(tmp_path / "port"))
    opts["port"]["outtmpl"] = opts["jax"]["outtmpl"] = ""
    assert opts["port"] == opts["jax"]
    assert opts["port"]["format"] == "bestaudio/best"
    assert opts["port"]["postprocessors"][0]["key"] == "FFmpegExtractAudio"


def test_download_retries_then_succeeds(fake_ytdlp, tmp_path):
    dl = AudioDownloader(output_dir=str(tmp_path), retries=2)
    _FakeYDL.fail_urls["u"] = 2          # fails twice, then succeeds
    assert dl.download_audio("u", instrument="harp") == tmp_path / "harp"
    assert len(_FakeYDL.calls) == 3
    assert dl.failures == []


def test_download_records_failure_after_retries(fake_ytdlp, tmp_path,
                                                capsys):
    dl = AudioDownloader(output_dir=str(tmp_path), retries=1)
    _FakeYDL.fail_urls["bad"] = 99
    assert dl.download_audio("bad") is None
    assert len(_FakeYDL.calls) == 2      # one try and one retry
    (url, err), = dl.failures
    assert url == "bad" and "simulated extractor" in err
    dl.report_failures()
    out = capsys.readouterr().out
    assert "1 download(s) failed" in out and "bad" in out


def test_download_from_csv_end_to_end(fake_ytdlp, tmp_path, capsys):
    csv_path = tmp_path / "urls.csv"
    csv_path.write_text("instrument,title,url\n"
                        "piano,sonata,https://yt/1\n"
                        "# skipped\n"
                        "violin,partita,https://yt/2\n"
                        "guitar,broken,https://yt/3\n")
    _FakeYDL.fail_urls["https://yt/3"] = 99
    dl = AudioDownloader(output_dir=str(tmp_path / "dl"), retries=0)
    dl.download_from_csv(str(csv_path))
    assert (tmp_path / "dl" / "piano" / "sonata.mp3").exists()
    assert (tmp_path / "dl" / "violin" / "partita.mp3").exists()
    assert not (tmp_path / "dl" / "guitar" / "broken.mp3").exists()
    assert [u for u, _ in dl.failures] == ["https://yt/3"]
    assert "1 download(s) failed" in capsys.readouterr().out


def test_download_from_file_list(fake_ytdlp, tmp_path, capsys):
    lst = tmp_path / "urls.txt"
    lst.write_text("# comment\nhttps://yt/a\n\nhttps://yt/b\n")
    dl = AudioDownloader(output_dir=str(tmp_path / "dl"))
    dl.download_from_file(str(lst))
    assert [u for _, u in _FakeYDL.calls] == [["https://yt/a"],
                                              ["https://yt/b"]]
    assert "completed successfully" in capsys.readouterr().out


def test_downloader_gated_without_ytdlp(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yt_dlp", None)
    dl = AudioDownloader(output_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="yt-dlp"):
        dl.download_audio("https://example.invalid/x", instrument="piano")
    if importlib.util.find_spec("yt_dlp") is None:
        monkeypatch.delitem(sys.modules, "yt_dlp")
        with pytest.raises(RuntimeError, match="yt-dlp"):
            dl.download_audio("https://example.invalid/x")


def test_downloader_csv_parsing_matches_jax(tmp_path, monkeypatch):
    csv_path = tmp_path / "urls.csv"
    csv_path.write_text("instrument,title,url\npiano, song a ,http://x/1\n"
                        "guitar,song b,http://x/2\n\n")
    calls = {}
    for name, cls in (("port", AudioDownloader), ("jax", JaxDownloader)):
        dl = cls(output_dir=str(tmp_path))
        calls[name] = []
        monkeypatch.setattr(
            dl, "download_audio",
            lambda url, instrument="", title=None, c=calls[name]: c.append(
                (instrument, title, url)))
        dl.download_from_csv(str(csv_path))
    assert calls["port"] == calls["jax"] == [
        ("piano", "song a", "http://x/1"), ("guitar", "song b", "http://x/2")]


@pytest.mark.parametrize("argv", [
    ["--csv", "urls.csv"], ["--file", "urls.txt"],
    ["--url", "https://yt/z", "--instrument", "cello"]])
def test_cli_download(fake_ytdlp, tmp_path, capsys, argv):
    (tmp_path / "urls.csv").write_text("cello,suite,https://yt/z\n")
    (tmp_path / "urls.txt").write_text("https://yt/z\n")
    argv = [a if not a.startswith("urls") else str(tmp_path / a)
            for a in argv]
    assert cli.main(["download", *argv, "--output-dir",
                     str(tmp_path / "dl")]) == 0
    assert [u for _, u in _FakeYDL.calls] == [["https://yt/z"]]
    assert "completed successfully" in capsys.readouterr().out
    assert len(list((tmp_path / "dl").rglob("*.mp3"))) == 1


def test_cli_download_needs_a_source(capsys):
    assert cli.main(["download"]) == 2
    assert "--csv/--file/--url" in capsys.readouterr().err


# ---------------- Hugging Face -------------------------------------------------


@pytest.fixture()
def fake_hf(monkeypatch):
    samples = [{"tags": ["Piano"], "id": 0}, {"tags": ["piano", "rock"],
                                                "id": 1},
               {"genres": "piano", "id": 2}, {"tags": [], "id": 3},
               {"tags": ["rock"], "id": 4}, {"tags": ["piano"], "id": 5}]
    seen = {}
    ds_mod = types.ModuleType("datasets")

    def load_dataset(name, split, streaming):
        seen["load"] = (name, split, streaming)
        return iter(samples)

    ds_mod.load_dataset = load_dataset
    hub = types.ModuleType("huggingface_hub")
    hub.login = lambda token: seen.__setitem__("token", token)
    monkeypatch.setitem(sys.modules, "datasets", ds_mod)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub)
    return seen


def test_hf_tag_filter_and_limit(fake_hf):
    assert [s["id"] for s in hf_utils.construct_hf_dataset("piano")] == [
        0, 2, 5]
    assert [s["id"] for s in hf_utils.construct_hf_dataset(
        "PIANO", limit=2)] == [0, 2]
    assert [s["id"] for s in hf_utils.construct_hf_dataset("rock")] == [4]
    assert fake_hf["load"] == ("benjamin-paine/free-music-archive-small",
                               "train", True)


def test_hf_authenticate(fake_hf, tmp_path, monkeypatch):
    monkeypatch.delenv("HF_TOKEN", raising=False)
    with pytest.raises(RuntimeError, match="HF_TOKEN"):
        hf_utils.authenticate(env_file=str(tmp_path / "missing"))
    (tmp_path / ".env.local").write_text("HF_TOKEN=tok\n")
    hf_utils.authenticate(env_file=str(tmp_path / ".env.local"))
    assert fake_hf["token"] == "tok"


def test_hf_gated_without_datasets(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(RuntimeError, match="datasets"):
        list(hf_utils.construct_hf_dataset("piano"))


# ---------------- .env ---------------------------------------------------------


def test_env_loader_matches_jax(tmp_path, monkeypatch):
    f = tmp_path / ".env.local"
    f.write_text("# comment\nHF_TOKEN='abc123'\nOTHER=x=y\n\nBAD LINE\n"
                 'QUOTED="q"\n')
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.delenv("OTHER", raising=False)
    monkeypatch.delenv("QUOTED", raising=False)
    parsed = load_env_file(f)
    assert parsed == jax_load_env_file(f) == {
        "HF_TOKEN": "abc123", "OTHER": "x=y", "QUOTED": "q"}
    assert os.environ["HF_TOKEN"] == "abc123"
    assert get_env("HF_TOKEN", env_file=f) == "abc123"
    assert get_env("MISSING", default="d", env_file=f) == "d"
    assert jax_get_env("MISSING", default="d", env_file=f) == "d"
    assert load_env_file(tmp_path / "none") == {}
    monkeypatch.setenv("OTHER", "kept")
    load_env_file(f)
    assert os.environ["OTHER"] == "kept"
    load_env_file(f, override=True)
    assert os.environ["OTHER"] == "x=y"
