"""The port's generate route, HTTP server and CLI on the CPU, and the
slice as a whole against the JAX package.

The behaviour tests mirror tests/test_serving.py: WAV and PNG inputs,
/v1/generate, 401, 413, 429, 504, multi-model routing, autoscaling and
generate stats; then the CLI's transfer (WAV -> PNG + WAV, overlapping
chunks, content phases) and generate on a port checkpoint.  The slice
test takes WAV bytes through the front end, the transfer and the audio
inverse on both packages with the JAX side's noise and shared phases.
"""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from music_style_transfer_ldm_tpu.audio.griffinlim import (
    mel_to_audio as jax_mel_to_audio,
)
from music_style_transfer_ldm_tpu.audio.mel import db_to_power as jax_db2p
from music_style_transfer_ldm_tpu.audio.processor import (
    AudioProcessor as JaxAudioProcessor,
)
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.models.ldm import (
    content_style_transfer as jax_transfer,
)
from music_style_transfer_ldm_tpu.serving.server import (
    _wav_to_image as jax_wav_to_image,
)
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.audio.griffinlim import mel_to_audio
from music_style_transfer_ldm_tpu_torch.audio.io import write_wav
from music_style_transfer_ldm_tpu_torch.audio.mel import db_to_power
from music_style_transfer_ldm_tpu_torch.audio.processor import (
    AudioProcessor,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    unit_image_to_db,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    LDM, build_ldm, content_style_transfer,
)
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine,
)
from music_style_transfer_ldm_tpu_torch.serving.server import (
    _wav_to_image, serve,
)
from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
    save_checkpoint,
)
from music_style_transfer_ldm_tpu_torch.utils.png import (
    read_png_gray, write_png_gray,
)

IMG_ATOL = 1.0 / 255.0 + 1e-5   # front-end images: one grid step at most
TRANSFER_ATOL = 1e-4            # decoded images, f32, 11 steps
GL_ATOL_REL = 1e-3              # x peak |audio|: Griffin-Lim, FFT order
QUICK = dict(steps=4, batch_buckets=(1, 2, 4), max_wait_ms=20.0,
             griffin_lim_iters=2, nnls_iters=4)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _small_ldm(seed=0):
    """A 20-step-schedule LDM at full width, random weights, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = LDM(num_timesteps=20)
    return model.requires_grad_(False).eval()


@pytest.fixture(scope="module")
def engine():
    eng = InferenceEngine(_small_ldm(), EngineConfig(sampler="fused",
                                                     **QUICK))
    eng.warmup()
    return eng


@pytest.fixture
def rng():
    return np.random.RandomState(42)


def _png_b64(rng):
    img = rng.randint(0, 256, (128, 130)).astype(np.uint8)
    return base64.b64encode(write_png_gray(img)).decode()


def _wav_bytes(seconds=2.0, sr=22050, f0=330.0):
    t = np.arange(int(seconds * sr)) / sr
    buf = io.BytesIO()
    write_wav(buf, (0.4 * np.sin(2 * np.pi * f0 * t)).astype(np.float32), sr)
    return buf.getvalue()


def _get(url, token=None, timeout=30):
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return urllib.request.urlopen(req, timeout=timeout)


def _post(url, payload, token=None, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return urllib.request.urlopen(req, timeout=timeout)


class _Server:
    """serve(block=False) as a context manager that stops everything."""

    def __init__(self, engine, **kw):
        self.engines = (list(engine.values()) if isinstance(engine, dict)
                        else [engine])
        self.httpd = serve(engine, host="127.0.0.1", port=0, block=False,
                           **kw)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        return self.base

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        for e in self.engines:
            e.stop()


# ---------------------------------------------------------------------------
# The engine's generate route and autoscaling
# ---------------------------------------------------------------------------


def test_engine_generate_shapes_determinism_and_stats(engine, rng):
    style = rng.rand(2, 128, 128, 1).astype(np.float32)
    before = engine.stats()["generate_calls"]
    out = engine.generate(style, seed=5)
    assert out["image"].shape == (2, 128, 128, 1)
    assert out["audio"].shape == (2, 3 * 22050)
    assert np.isfinite(out["audio"]).all()
    assert 0.0 <= out["image"].min() and out["image"].max() <= 1.0
    again = engine.generate(style, seed=5)
    np.testing.assert_array_equal(out["image"], again["image"])
    other = engine.generate(style, seed=6)
    assert np.abs(out["image"] - other["image"]).max() > 1e-6
    stats = engine.stats()
    assert stats["generate_calls"] - before == 3
    assert stats["generate_waiting"] == 0


def test_generate_waits_for_its_lock_at_most_the_timeout(engine, rng):
    style = rng.rand(1, 128, 128, 1).astype(np.float32)
    errors = []

    def call():
        try:
            engine.generate(style, timeout=0.5)
        except TimeoutError as e:
            errors.append(e)

    with engine._gen_lock:
        th = threading.Thread(target=call)
        th.start()
        deadline = time.monotonic() + 10
        while (engine.stats()["generate_waiting"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        # A waiting generate call counts as pending load.
        assert engine.stats()["generate_waiting"] == 1
        assert engine.pending() >= 1
        th.join(timeout=30)
    assert len(errors) == 1 and "not free within" in str(errors[0])
    assert engine.stats()["generate_waiting"] == 0


def test_concurrent_generate_keeps_its_counters(engine, rng):
    """More generate callers than cores, with fast thread switching: every
    call runs once behind the lock and the counters lose no update."""
    import os
    import sys
    style = rng.rand(1, 128, 128, 1).astype(np.float32)
    n = 2 * (os.cpu_count() or 4)
    before = engine.stats()["generate_calls"]
    results, errors = [], []

    def call(seed):
        try:
            results.append(engine.generate(style, seed=seed)["image"])
        except Exception as e:  # noqa: BLE001 — collected and asserted
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(prev)
    assert not any(th.is_alive() for th in threads), "a caller hung"
    assert not errors, errors[:1]
    assert len(results) == n
    stats = engine.stats()
    assert stats["generate_calls"] - before == n
    assert stats["generate_waiting"] == 0


def test_engine_config_generate_grid(rng, monkeypatch):
    """generate_steps and generate_guidance reach the sampler, apart from
    the transfer grid; the scan DDIM serves generation on a fused
    engine."""
    from music_style_transfer_ldm_tpu_torch.serving import engine as mod
    calls = []
    real = mod.style_ddim_sample

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)
    monkeypatch.setattr(mod, "style_ddim_sample", spy)
    style = rng.rand(1, 128, 128, 1).astype(np.float32)
    kw = dict(QUICK, invert_audio=False, sampler="fused")
    outs = []
    for steps, guidance in ((3, 2.0), (2, 1.0)):
        eng = InferenceEngine(_small_ldm(), EngineConfig(
            generate_steps=steps, generate_guidance=guidance, **kw))
        out = eng.generate(style, seed=0)
        assert out["image"].shape == (1, 128, 128, 1)
        assert "audio" not in out
        outs.append(out["image"])
    assert [(c["timesteps"], c["guidance"], c["sampler"]) for c in calls] == [
        (3, 2.0, "ddim"), (2, 1.0, "ddim")]
    assert np.abs(outs[0] - outs[1]).max() > 1e-6
    eng = InferenceEngine(_small_ldm(), EngineConfig(**kw))
    eng.generate(style, seed=0)
    assert calls[-1]["timesteps"] == QUICK["steps"]   # default: steps


def test_bucket_autoscaling(engine):
    cfg = dataclasses.replace(engine.config, autoscale=True,
                              autoscale_after=2, max_bucket=8,
                              invert_audio=False)
    eng = InferenceEngine(engine.ldm, cfg)
    eng._warm_buckets = frozenset(cfg.batch_buckets)
    eng._queue.put(("x",) * 4)           # a request still queued
    for _ in range(cfg.autoscale_after):
        eng._maybe_autoscale(4, 4)
    deadline = time.monotonic() + 120
    while 8 not in eng._warm_buckets and time.monotonic() < deadline:
        time.sleep(0.1)
    assert 8 in eng._warm_buckets, "bucket 8 was not adopted"
    assert eng.stats()["autoscaled_buckets"] == 1
    eng._maybe_autoscale(8, 8)           # below the threshold: no 16
    assert 16 not in eng._warm_buckets and 16 not in eng._warming


# ---------------------------------------------------------------------------
# The HTTP server
# ---------------------------------------------------------------------------


def test_http_png_transfer_stats_and_errors(engine, rng):
    with _Server(engine) as base:
        with _get(f"{base}/healthz") as r:
            assert json.loads(r.read()) == {"status": "ok"}
        png = _png_b64(rng)
        with _post(f"{base}/v1/transfer", {"content_png_b64": png,
                                           "style_png_b64": png}) as r:
            resp = json.loads(r.read())
        img = read_png_gray(base64.b64decode(resp["image_png_b64"]))
        assert img.shape == (128, 128)
        sr, wav = wavfile.read(io.BytesIO(
            base64.b64decode(resp["audio_wav_b64"])))
        assert sr == 22050 and wav.shape == (3 * 22050,)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/transfer", {"style_png_b64": png})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/nothing", {})
        assert e.value.code == 404
        with _get(f"{base}/stats") as r:
            assert json.loads(r.read())["requests"] >= 1


def test_http_wav_content_and_generate(engine, rng):
    wav_b64 = base64.b64encode(_wav_bytes()).decode()
    with _Server(engine) as base:
        with _post(f"{base}/v1/transfer", {"content_wav_b64": wav_b64,
                                           "style_png_b64": _png_b64(rng),
                                           "seed": 5}) as r:
            assert "image_png_b64" in json.loads(r.read())
        before = engine.stats()["generate_calls"]
        for path in ("/v1/generate", "/v1/models/default/generate"):
            with _post(f"{base}{path}", {"style_wav_b64": wav_b64,
                                         "seed": 3}) as r:
                resp = json.loads(r.read())
            assert read_png_gray(base64.b64decode(
                resp["image_png_b64"])).shape == (128, 128)
            assert "audio_wav_b64" in resp
        assert engine.stats()["generate_calls"] - before == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/generate", {"seed": 1})
        assert e.value.code == 400


def test_http_oversized_request_rejected(engine):
    with _Server(engine) as base:
        body = b'{"content_png_b64": "' + b"A" * (33 * 1024 * 1024) + b'"}'
        req = urllib.request.Request(f"{base}/v1/transfer", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 413


def test_http_bearer_auth(engine, rng):
    with _Server(engine, auth_token="sekrit") as base:
        with _get(f"{base}/healthz") as r:
            assert r.status == 200
        for token in (None, "wrong"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(f"{base}/stats", token=token)
            assert e.value.code == 401
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/generate", {}, token=token)
            assert e.value.code == 401
        png = _png_b64(rng)
        with _post(f"{base}/v1/transfer", {"content_png_b64": png,
                                           "style_png_b64": png},
                   token="sekrit") as r:
            assert r.status == 200


def test_http_timeouts_return_504(engine, rng):
    png = _png_b64(rng)
    with _Server(engine, request_timeout_s=0.0) as base:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/transfer", {"content_png_b64": png,
                                          "style_png_b64": png})
        assert e.value.code == 504
        assert "timed out" in json.loads(e.value.read())["error"]
    with _Server(engine, request_timeout_s=0.2) as base:
        with engine._gen_lock:               # a generate call in flight
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/generate", {"style_png_b64": png})
        assert e.value.code == 504


def test_http_load_shedding_returns_429(engine, rng):
    with _Server(engine, max_queue=0) as base:
        png = _png_b64(rng)
        for op in ("transfer", "generate"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(f"{base}/v1/{op}", {"content_png_b64": png,
                                          "style_png_b64": png})
            assert e.value.code == 429
            assert e.value.headers["Retry-After"] == "1"
        with _get(f"{base}/stats") as r:
            assert "pending" in json.loads(r.read())


def test_multi_model_routing(engine, rng):
    with _Server({"alpha": engine, "beta": engine}) as base:
        with _get(f"{base}/v1/models") as r:
            assert json.loads(r.read()) == {"models": ["alpha", "beta"],
                                            "default": "alpha"}
        png = _png_b64(rng)
        body = {"content_png_b64": png, "style_png_b64": png}
        with _post(f"{base}/v1/transfer", body) as r:
            assert r.status == 200
        with _post(f"{base}/v1/models/beta/transfer", body) as r:
            assert "image_png_b64" in json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{base}/v1/models/nope/transfer", body)
        assert e.value.code == 404
        with _get(f"{base}/stats") as r:
            assert set(json.loads(r.read())["models"]) == {"alpha", "beta"}


# ---------------------------------------------------------------------------
# The CLI on a port checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    save_checkpoint(d / "ckpt.pt", build_ldm(device="cpu", seed=0))
    sr = 44100
    t = np.arange(int(4.5 * sr)) / sr
    rng = np.random.RandomState(0)
    stereo = np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                       0.3 * np.sin(2 * np.pi * 330 * t)
                       + 0.02 * rng.randn(len(t))], axis=1)
    stereo[: sr // 2] = 0.0                  # silence to trim
    wavfile.write(d / "content.wav", sr, (stereo * 32767).astype(np.int16))
    return d


def _run_cli(files, *argv):
    return cli.main([*argv, "--checkpoint", str(files / "ckpt.pt"),
                     "--device", "cpu"])


def test_cli_transfer_wav_to_png_and_wav(files, capsys):
    out = files / "out" / "transfer"
    assert _run_cli(files, "transfer", "--content",
                    str(files / "content.wav"), "--style",
                    str(files / "content.wav"), "--steps", "4",
                    "--sampler", "fused", "--overlap", "0.5",
                    "--phase-init", "content", "--output", str(out)) == 0
    ap = AudioProcessor(device="cpu")
    trimmed = ap.trim_silence(ap.load_audio(files / "content.wav")[0])
    hop = int(1.5 * 22050)
    n = len(range(0, len(trimmed), hop))
    assert n == 3
    png = read_png_gray(out.with_suffix(".png").read_bytes())
    assert png.shape == (128, 128 * n)
    sr, wav = wavfile.read(out.with_suffix(".wav"))
    assert sr == 22050 and wav.shape == ((n - 1) * hop + 66150,)
    assert "wrote" in capsys.readouterr().out


def test_cli_generate_and_scan_transfer(files):
    gen = files / "out" / "generate"
    assert _run_cli(files, "generate", "--style", str(files / "content.wav"),
                    "--steps", "3", "--sampler", "fused",
                    "--output", str(gen)) == 0
    assert read_png_gray(gen.with_suffix(".png").read_bytes()).shape == (
        128, 128)
    assert wavfile.read(gen.with_suffix(".wav"))[1].shape == (66150,)
    tr = files / "out" / "png_content"
    assert _run_cli(files, "transfer", "--content", str(gen) + ".png",
                    "--style", str(gen) + ".png", "--steps", "3",
                    "--sampler", "ddim", "--match-level",
                    "--output", str(tr)) == 0
    assert wavfile.read(tr.with_suffix(".wav"))[1].shape == (66150,)


def test_cli_refuses_bad_combinations(files):
    png = str(files / "out" / "generate.png")
    with pytest.raises(SystemExit, match="needs audio content"):
        _run_cli(files, "transfer", "--content", png, "--style", png,
                 "--overlap", "0.5")
    with pytest.raises(SystemExit, match="needs the scan samplers"):
        _run_cli(files, "generate", "--style", png, "--sampler", "fused",
                 "--guidance", "2")
    with pytest.raises(SystemExit, match="must be in"):
        _run_cli(files, "transfer", "--content", png, "--style", png,
                 "--overlap", "1.0")
    args = cli.build_parser().parse_args(["serve", "--checkpoint", "c"])
    assert args.device == "cuda" and args.steps == 50
    assert args.mesh_dp == 1


def test_cli_distill_advisories(tmp_path, capsys):
    path = tmp_path / "student.pt"
    save_checkpoint(path, build_ldm(device="cpu"),
                    distill={"steps": 6, "t_max": 50, "stages": [12, 6]})
    p = cli.build_parser()
    args = p.parse_args(["transfer", "--checkpoint", str(path), "--content",
                         "c", "--style", "s"])
    cli._warn_distill_mismatch(args)
    assert "distilled for --steps 50 --sample-steps 7" in (
        capsys.readouterr().err)
    args = p.parse_args(["transfer", "--checkpoint", str(path), "--content",
                         "c", "--style", "s", "--steps", "50",
                         "--sample-steps", "7"])
    cli._warn_distill_mismatch(args)
    assert capsys.readouterr().err == ""
    gen = p.parse_args(["generate", "--checkpoint", str(path), "--style",
                        "s"])
    cli._warn_generate_distill_mismatch(gen, 200)
    assert "distilled for TRANSFER" in capsys.readouterr().err
    sv = p.parse_args(["serve", "--checkpoint", str(path)])
    ecfg = cli._serve_engine_config(EngineConfig(steps=50), sv, str(path),
                                    "default")
    assert (ecfg.steps, ecfg.sample_steps) == (50, 7)
    assert "serving on its trained grid" in capsys.readouterr().out


def test_chunk_seeds_are_distinct_and_stable():
    a = cli.chunk_seeds(0, 4)
    assert len(set(a.tolist())) == 4 and (a >= 0).all()
    np.testing.assert_array_equal(a, cli.chunk_seeds(0, 4))
    # seed + index would alias seed 1's first chunk with seed 0's second.
    assert cli.chunk_seeds(1, 1)[0] != a[1]


# ---------------------------------------------------------------------------
# The slice as a whole against the JAX package
# ---------------------------------------------------------------------------


def test_wav_bytes_to_audio_matches_jax():
    rng = np.random.RandomState(7)
    model = JaxLDM(dtype=jnp.float32)
    x = jnp.zeros((1, 128, 128, 1), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "diffusion": jax.random.PRNGKey(1)},
                           x, x, jnp.zeros((1,), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_ldm(device="cpu")
    load_flax_variables(port, variables)
    ap, jap = AudioProcessor(device="cpu"), JaxAudioProcessor()

    # WAV bytes -> images (resample 44.1 kHz stereo, trim, front end).
    sr = 44100
    t = np.arange(3 * sr) / sr
    stereo = np.stack([0.3 * np.sin(2 * np.pi * 196 * t),
                       0.2 * np.sin(2 * np.pi * 523 * t)
                       + 0.01 * rng.randn(len(t))], axis=1)
    buf = io.BytesIO()
    wavfile.write(buf, sr, (stereo * 32767).astype(np.int16))
    images = []
    for f0 in (0, 1):
        got = _wav_to_image(buf.getvalue(), ap)
        want = jax_wav_to_image(buf.getvalue(), jap)
        np.testing.assert_allclose(got, want, atol=IMG_ATOL)
        images.append(got)
        buf = io.BytesIO(_wav_bytes(3.0, 22050, 261.6))
    content, style = images[0][None], images[1][None]

    # Transfer with the JAX side's per-item noise injected.
    keys = jax.random.split(jax.random.PRNGKey(9), 1)
    want, _, _ = jax_transfer(model, variables, keys, jnp.asarray(content),
                              jnp.asarray(style), num_timesteps=12)
    z_0 = model.apply(variables, jnp.asarray(content), method=JaxLDM.encode)
    noise = np.asarray(jax.vmap(lambda k, z: jax.random.normal(
        k, z.shape, jnp.float32))(keys, z_0))
    got, _ = content_style_transfer(port, torch.tensor(content),
                                    torch.tensor(style), num_timesteps=12,
                                    noise=torch.tensor(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TRANSFER_ATOL)

    # The engine's audio inverse with shared Griffin-Lim phases.
    angles = rng.uniform(0, 2 * np.pi, (1, 1025, 128)).astype(np.float32)
    want_audio = np.asarray(jax_mel_to_audio(
        jax_db2p(np.asarray(want)[:, :, :, 0] * 80.0 - 80.0), n_iter=4,
        nnls_iters=8, length=66150, init_phase=jnp.asarray(angles)))
    got_audio = mel_to_audio(db_to_power(unit_image_to_db(got[:, :, :, 0])),
                             n_iter=4, nnls_iters=8, length=66150,
                             init_phase=torch.tensor(angles)).numpy()
    assert got_audio.shape == want_audio.shape == (1, 66150)
    np.testing.assert_allclose(got_audio, want_audio,
                               atol=GL_ATOL_REL * np.abs(want_audio).max())
