"""Riffusion v1 in the port, at a tiny size on the CPU, against the plain
reference (``tests/riffusion_reference.py``) on seeded weights: the text
encoder, the UNet, the VAE, the guided SDEdit transfer through
``InferenceEngine.transfer_batch`` with its audio, the reference's text
encoder against ``transformers``' ``CLIPTextModel``, the reference
against the benchmark's copy, the ``scaled_linear`` betas, the published
parameter counts (on the meta device), ``cli transfer`` and ``cli serve``
with prompt ids, the new spans and counters, and the LDM's route
unchanged."""

import base64
import dataclasses
import io
import json
import os
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import riffusion_reference as R
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.audio import griffinlim
from music_style_transfer_ldm_tpu_torch.audio import riffusion as riff_audio
from music_style_transfer_ldm_tpu_torch.audio.io import write_wav
from music_style_transfer_ldm_tpu_torch.config import (
    RiffusionConfig, SDUNetConfig, TextEncoderConfig, VAEConfig,
    riffusion_audio_config,
)
from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule, scaled_linear_beta_schedule,
)
from music_style_transfer_ldm_tpu_torch.models.clip_text import prompt_ids
from music_style_transfer_ldm_tpu_torch.models.riffusion import (
    Riffusion, riffusion_transfer,
)
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine, LDMRoute,
)
from music_style_transfer_ldm_tpu_torch.utils import profiling
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

ROOT = Path(__file__).resolve().parents[1]
SERVE = {"num_timesteps": 750, "sample_steps": 6, "guidance": 7.0}


def tiny_config() -> RiffusionConfig:
    return RiffusionConfig(
        text=TextEncoderConfig(vocab_size=64, width=32, layers=2, heads=4,
                               mlp_dim=64, bos_id=62, eos_id=63),
        unet=SDUNetConfig(block_out_channels=(32, 64),
                          cross_attention=(True, False), layers_per_block=1,
                          heads=4, cross_attention_dim=32, groups=8,
                          time_proj_dim=32, time_embed_dim=64),
        vae=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                      groups=8),
        image_size=32)


def tiny_audio():
    return dataclasses.replace(
        riffusion_audio_config(), sample_rate=8000, n_fft=256,
        win_length=128, hop_length=64, n_mels=32, fmax=3000.0,
        clip_seconds=32 * 64 / 8000)


def audio_dict(a) -> dict:
    return dict(dataclasses.asdict(a), nnls_iters=64, griffin_lim_iters=32)


@pytest.fixture(scope="module")
def tiny():
    """(model dict, weights, the port's f32 model with them)."""
    cfg = tiny_config()
    d = dataclasses.asdict(cfg)
    W = R.seeded_weights(d, 2 ** 33 + 5, "cpu")
    with torch.device("meta"):
        m = Riffusion(cfg, tiny_audio())
    for part in ("text_encoder", "unet", "vae"):
        getattr(m, part).load_state_dict(W[part], assign=True)
    m.requires_grad_(False)
    return d, W, m.eval()


def ids_of(cfg_text, rows, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([prompt_ids(rng.integers(0, cfg_text.bos_id, n), cfg_text)
                     for n in rng.integers(1, 8, rows)])


def test_text_encoder_matches_reference(tiny):
    d, W, m = tiny
    ids = torch.as_tensor(ids_of(m.config.text, 3))
    got = m.text_encoder(ids)
    want = R.text_encoder(W["text_encoder"], ids, d["text"])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_unet_matches_reference(tiny):
    d, W, m = tiny
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 4, 4, generator=g)
    t = torch.tensor([0, 400, 999])
    ctx = torch.randn(3, 77, 32, generator=g)
    got = m.unet(x, t, ctx)
    want = R.unet(W["unet"], x, t, ctx, d["unet"])
    assert got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_vae_matches_reference(tiny):
    d, W, m = tiny
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    z = m.vae.encode_mean(2 * x - 1)
    torch.testing.assert_close(z, R.vae_encode_mean(W["vae"], 2 * x - 1,
                                                    d["vae"]),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(m.vae.decode(z),
                               R.vae_decode(W["vae"], z, d["vae"]),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def engine(tiny):
    _, _, m = tiny
    eng = InferenceEngine(m, EngineConfig(
        steps=SERVE["num_timesteps"], sample_steps=SERVE["sample_steps"],
        guidance=SERVE["guidance"], generate_guidance=SERVE["guidance"],
        generate_steps=4, batch_buckets=(1, 2)))
    eng.warmup()
    return eng


def test_engine_transfer_matches_reference(tiny, engine):
    d, W, m = tiny
    rng = np.random.default_rng(3)
    content = rng.random((3, 32, 32, 1), dtype=np.float32)
    ids = ids_of(m.config.text, 3, seed=4)
    seeds = np.array([11, 12, 13])
    out = engine.transfer_batch(content, ids, seeds)
    want = R.transfer(W, torch.as_tensor(content[..., 0]),
                      torch.as_tensor(ids), seeds.tolist(), d, SERVE)
    assert out["image"].shape == (3, 32, 32, 1)
    np.testing.assert_allclose(out["image"][..., 0], want.numpy(), rtol=0,
                               atol=1e-4)
    aud = R.image_to_audio(torch.as_tensor(out["image"][..., 0]),
                           audio_dict(m.audio_config))
    assert out["audio"].shape == aud.shape == (3, 2048)
    gap = np.abs(out["audio"] - aud.numpy()).max(1) / np.abs(
        aud.numpy()).max(1)
    assert gap.max() < 1e-4
    # a request's result does not depend on its batch
    one = engine.transfer_batch(content[1:2], ids[1:2], seeds[1:2])
    np.testing.assert_allclose(one["image"], out["image"][1:2], rtol=0,
                               atol=1e-5)


def test_generate_route_and_stats(tiny, engine):
    _, _, m = tiny
    before = engine.stats()
    out = engine.generate(ids_of(m.config.text, 1), seed=5)
    assert out["image"].shape == (1, 32, 32, 1)
    assert np.isfinite(out["audio"]).all()
    after = engine.stats()
    assert after["prompts_encoded"] - before["prompts_encoded"] == 1
    assert after["guided_rows"] - before["guided_rows"] == 2 * 3


def test_reference_and_the_benchmarks_copy_agree(tiny):
    sys.path.insert(0, str(ROOT))
    from portbench.reference import riffusion as copy
    d, W, _ = tiny
    content = torch.rand(2, 32, 32, generator=torch.Generator().manual_seed(7))
    ids = torch.as_tensor(ids_of(tiny[2].config.text, 2, seed=8))
    a = R.transfer(W, content, ids, [1, 2], d, SERVE)
    b = copy.transfer(W, content, ids, [1, 2], d, SERVE)
    assert torch.equal(a, b)
    audio = audio_dict(tiny_audio())
    assert torch.equal(R.image_to_audio(a, audio),
                       copy.image_to_audio(a, audio))
    assert R.unet_spec(d["unet"]) == copy.unet_spec(d["unet"])


def test_scaled_linear_betas():
    betas = scaled_linear_beta_schedule(1000, 0.00085, 0.012)
    assert betas.dtype == np.float32 and betas.shape == (1000,)
    np.testing.assert_allclose(betas[[0, -1]], [0.00085, 0.012], rtol=1e-6)
    want = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    np.testing.assert_allclose(betas, want, rtol=1e-6)
    sched = DiffusionSchedule(1000, 0.00085, 0.012, kind="scaled_linear")
    np.testing.assert_array_equal(
        sched.alpha_bars_np,
        R.alpha_bars({"beta_start": 0.00085, "beta_end": 0.012,
                      "num_timesteps": 1000}))
    assert abs(float(sched.alpha_bars_np[749]) - 0.0566) < 1e-3
    # the default stays linear
    np.testing.assert_array_equal(
        DiffusionSchedule(200).betas_np,
        np.linspace(1e-4, 0.02, 200, dtype=np.float64).astype(np.float32))


@pytest.mark.parametrize("part,count", [("unet", 859_520_964),
                                        ("vae", 83_653_863),
                                        ("text_encoder", 123_060_480)])
def test_published_parameter_counts(part, count):
    with torch.device("meta"):
        m = Riffusion()
    assert sum(p.numel() for p in getattr(m, part).parameters()) == count
    spec = {"unet": R.unet_spec, "vae": R.vae_spec,
            "text_encoder": R.text_spec}[part]
    key = {"text_encoder": "text"}.get(part, part)
    names = dict(getattr(m, part).named_parameters())
    shapes = {n: tuple(s) for n, s, _ in spec(
        dataclasses.asdict(RiffusionConfig())[key])}
    assert shapes == {n: tuple(p.shape) for n, p in names.items()}


def test_prompt_ids():
    c = TextEncoderConfig()
    ids = prompt_ids([5, 6], c)
    assert ids.shape == (77,) and ids.dtype == np.int64
    assert ids[:4].tolist() == [49406, 5, 6, 49407]
    assert (ids[3:] == 49407).all()
    assert prompt_ids([], c)[:2].tolist() == [49406, 49407]
    with pytest.raises(ValueError):
        prompt_ids([49406], c)
    with pytest.raises(ValueError):
        prompt_ids(list(range(76)), c)


def test_image_law_round_trip():
    a = riffusion_audio_config()
    mel = torch.rand(2, 8, 5, generator=torch.Generator().manual_seed(9))
    img = riff_audio.mel_to_image(mel, a)
    # highest mel bin on the first row, the loudest bin darkest
    back = riff_audio.image_to_mel(img, a)
    top = mel.amax((-2, -1), keepdim=True)
    np.testing.assert_allclose((back / a.max_value).numpy(),
                               (mel / top).numpy(), atol=0.05)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_graph_key_separates_the_filterbank():
    M, phase = torch.zeros(2, 32, 8), torch.zeros(129, 8)
    base = dict(sr=8000, n_fft=256, hop_length=64, win_length=128,
                power=1.0, n_iter=4, nnls_iters=4, length=None)
    keys = {griffinlim._graph_key(M, phase, **base, mel=mel) for mel in (
        (0.0, None, False, "slaney"), (0.0, 3000.0, False, "slaney"),
        (0.0, None, True, "slaney"), (0.0, None, False, None),
        (10.0, None, False, "slaney"))}
    assert len(keys) == 5
    assert griffinlim._graph_key(M, phase, **base) == griffinlim._graph_key(
        M, phase, **base, mel=(0.0, None, False, "slaney"))


def test_spans_and_counters(tiny, engine):
    _, _, m = tiny
    tracer = profiling.enable()
    try:
        engine.transfer_batch(np.zeros((2, 32, 32, 1), np.float32),
                              ids_of(m.config.text, 2), np.array([1, 2]))
    finally:
        profiling.disable()
    names = [r.name for r in tracer.spans()]
    for name in ("riffusion.text", "ldm.encode", "ldm.sample", "ldm.decode",
                 "audio.nnls", "audio.griffin_lim", "engine.upload",
                 "engine.readback"):
        assert name in names, name
    assert names.index("ldm.encode") < names.index("riffusion.text") \
        < names.index("ldm.sample") < names.index("ldm.decode")
    calls = SERVE["sample_steps"] - 1
    assert tracer.counters["unet.calls"] == calls
    assert tracer.counters["unet.rows"] == calls * 2 * 2


def test_ldm_route_unchanged():
    """The LDM's engine output is the pipeline it was before a second
    model family existed: the scan transfer, the dB law, Slaney NNLS and
    Griffin-Lim, 3 s of audio, bit for bit."""
    from music_style_transfer_ldm_tpu_torch.audio.mel import db_to_power
    from music_style_transfer_ldm_tpu_torch.audio.quantize import (
        unit_image_to_db,
    )
    from music_style_transfer_ldm_tpu_torch.models.ldm import (
        build_ldm, transfer_decoded,
    )
    ldm = build_ldm(device="cpu", seed=3)
    eng = InferenceEngine(ldm, EngineConfig(steps=4, batch_buckets=(2,),
                                            griffin_lim_iters=2,
                                            nnls_iters=2))
    assert isinstance(eng.route, LDMRoute) and eng.config.image_size == 128
    assert eng.audio == type(eng.audio)()
    rng = np.random.default_rng(10)
    c = rng.random((2, 128, 128, 1), dtype=np.float32)
    s = rng.random((2, 128, 128, 1), dtype=np.float32)
    out = eng.transfer_batch(c, s, np.array([3, 4]))
    with torch.no_grad():
        img, _ = transfer_decoded(ldm, torch.as_tensor(c), torch.as_tensor(s),
                                  num_timesteps=4, seeds=np.array([3, 4]))
        audio = griffinlim.mel_to_audio(
            db_to_power(unit_image_to_db(img[..., 0])), sr=22050,
            n_fft=2048, hop_length=512, n_iter=2, nnls_iters=2,
            length=66150)
    assert np.array_equal(out["image"], img.numpy())
    assert np.array_equal(out["audio"], audio.numpy())
    assert "guided_rows" in eng.stats() and eng.stats()["guided_rows"] == 0


def _wav_bytes(seconds=0.3, sr=8000) -> bytes:
    t = np.arange(int(seconds * sr)) / sr
    buf = io.BytesIO()
    write_wav(buf, 0.5 * np.sin(2 * np.pi * 440 * t).astype(np.float32), sr)
    return buf.getvalue()


def test_cli_transfer_riffusion(tiny, tmp_path, monkeypatch, capsys):
    _, _, m = tiny
    monkeypatch.setattr(cli, "load_riffusion", lambda *a, **k: m)
    wav = tmp_path / "c.wav"
    wav.write_bytes(_wav_bytes(0.4))
    out = tmp_path / "out" / "t"
    assert cli.main(["transfer", "--model", "riffusion-v1", "--content",
                     str(wav), "--prompt-ids", "1,2,3", "--sample-steps",
                     "3", "--device", "cpu", "--output", str(out)]) == 0
    assert out.with_suffix(".png").stat().st_size > 0
    from scipy.io import wavfile
    sr, data = wavfile.read(out.with_suffix(".wav"))
    # 0.4 s of content: two chunks of 0.256 s
    assert sr == 8000 and len(data) == 2 * 2048
    assert "seeded" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["transfer", "--content", str(wav), "--device", "cpu"])


def test_cli_serve_riffusion_prompt_ids(tiny, monkeypatch):
    _, _, m = tiny
    monkeypatch.setattr(cli, "load_riffusion", lambda *a, **k: m)
    args = cli.build_parser().parse_args([
        "serve", "--model", "riffusion-v1", "--device", "cpu", "--buckets",
        "1", "2", "--sample-steps", "3", "--port", "0"])
    engines = cli.build_engines(args)
    eng = engines["default"]
    assert eng.route is m and eng.config.steps == 750
    assert eng.config.guidance == eng.config.generate_guidance == 7.0
    from music_style_transfer_ldm_tpu_torch.serving.server import serve
    httpd = serve(eng, port=0, block=False)
    try:
        port = httpd.server_address[1]
        png = base64.b64encode(write_png_gray(
            np.full((32, 32), 128, np.uint8))).decode()
        for route, body in (
                ("transfer", {"content_png_b64": png, "prompt_ids": [1, 2]}),
                ("transfer", {"content_wav_b64": base64.b64encode(
                    _wav_bytes()).decode(), "prompt_ids": [3]}),
                ("generate", {"prompt_ids": [4, 5], "seed": 2})):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/{route}",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                resp = json.loads(r.read())
            assert {"image_png_b64", "audio_wav_b64"} <= set(resp), resp
    finally:
        httpd.shutdown()
        eng.stop()


def test_riffusion_transfer_is_seeded(tiny):
    _, _, m = tiny
    c = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    ids = torch.as_tensor(ids_of(m.config.text, 2))
    a = riffusion_transfer(m, c, ids, steps=3, seeds=np.array([1, 2]))
    b = riffusion_transfer(m, c, ids, steps=3, seeds=np.array([1, 2]))
    d = riffusion_transfer(m, c, ids, steps=3, seeds=np.array([1, 3]))
    assert torch.equal(a, b) and not torch.equal(a[1], d[1])


def test_reference_against_transformers_clip(tiny):
    # transformers' own TensorFlow and flax back ends stay out: their
    # import alone takes seconds, and TensorFlow's thread pools slow the
    # tests that follow in the same process
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    transformers = pytest.importorskip("transformers")
    d, W, m = tiny
    t = d["text"]
    hf = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=t["vocab_size"], hidden_size=t["width"],
        intermediate_size=t["mlp_dim"], num_hidden_layers=t["layers"],
        num_attention_heads=t["heads"],
        max_position_embeddings=t["max_positions"], hidden_act="quick_gelu",
        layer_norm_eps=t["eps"], bos_token_id=t["bos_id"],
        eos_token_id=t["eos_id"], pad_token_id=t["eos_id"])).eval()
    missing, unexpected = hf.load_state_dict(W["text_encoder"], strict=False)
    assert not unexpected and all("position_ids" in k for k in missing)
    ids = torch.as_tensor(ids_of(m.config.text, 2, seed=6))
    with torch.no_grad():
        want = hf(input_ids=ids).last_hidden_state
    torch.testing.assert_close(R.text_encoder(W["text_encoder"], ids, t),
                               want, rtol=0, atol=1e-5)
