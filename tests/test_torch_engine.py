"""The port's whole transfer path and its serving engine, on the CPU.

The transfer is held to the JAX package's ``content_style_transfer`` with
the JAX side's own per-item noise injected; the engine tests check the
bucket ladder, the routes, grouping invariance, audio and the async API.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.models.ldm import (
    content_style_transfer as jax_transfer,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    build_ldm, content_style_transfer, match_moments,
)
from music_style_transfer_ldm_tpu_torch.ops.fused_sampler import (
    FUSED_MAX_BATCH, fused_content_style_transfer,
)
from music_style_transfer_ldm_tpu_torch.serving import engine as engine_mod
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine,
)
from music_style_transfer_ldm_tpu_torch.utils import chips

TRANSFER_ATOL = 1e-4   # decoded images in [0, 1], f32, 11 steps
GROUPING_ATOL = 1e-5   # same request alone or batched (CPU conv sum order)
QUICK = dict(steps=12, griffin_lim_iters=4, nnls_iters=8)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(7)
    model = JaxLDM(dtype=jnp.float32)
    x = jnp.asarray(rng.rand(1, 128, 128, 1), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "diffusion": jax.random.PRNGKey(1)},
                           x, x, jnp.zeros((1,), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_ldm(device="cpu")
    load_flax_variables(port, variables)
    content = rng.rand(8, 128, 128, 1).astype(np.float32)
    style = rng.rand(8, 128, 128, 1).astype(np.float32)
    return model, variables, port, content, style


def _jax_noise(model, variables, keys, content):
    """The per-item draw of the JAX package's transfer (models/ldm.py)."""
    z_0 = model.apply(variables, jnp.asarray(content), method=JaxLDM.encode)
    return np.asarray(jax.vmap(
        lambda k, z: jax.random.normal(k, z.shape, jnp.float32))(keys, z_0))


@pytest.mark.parametrize("route,guidance", [("scan", 1.0), ("scan", 2.5),
                                           ("fused", 1.0)])
def test_transfer_matches_jax(pair, route, guidance):
    model, variables, port, content, style = pair
    c, s = content[:3], style[:3]
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    want, want_zt, _ = jax_transfer(model, variables, keys, jnp.asarray(c),
                                    jnp.asarray(s), num_timesteps=12,
                                    guidance=guidance)
    noise = torch.tensor(_jax_noise(model, variables, keys, c))
    if route == "scan":
        got, got_zt = content_style_transfer(
            port, torch.tensor(c), torch.tensor(s), num_timesteps=12,
            noise=noise, guidance=guidance)
        np.testing.assert_allclose(got_zt.numpy(), np.asarray(want_zt),
                                   atol=TRANSFER_ATOL)
    else:
        got = fused_content_style_transfer(
            port, torch.tensor(c), torch.tensor(s), num_timesteps=12,
            noise=noise)
    assert tuple(got.shape) == (3, 128, 128, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TRANSFER_ATOL)


def test_match_moments_matches_jax(pair):
    from music_style_transfer_ldm_tpu.models.ldm import (
        match_moments as jax_match,
    )
    _, _, _, content, style = pair
    want = jax_match(jnp.asarray(content[:2]), jnp.asarray(style[:2]))
    got = match_moments(torch.tensor(content[:2]), torch.tensor(style[:2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.fixture(scope="module")
def engine(pair):
    _, _, port, _, _ = pair
    # The limit is pinned so that the ladder exercises both routes.
    eng = InferenceEngine(port, EngineConfig(sampler="fused",
                                             fused_bucket_max=4, **QUICK))
    eng.warmup()
    return eng


def _spy(monkeypatch):
    calls = []
    fused, scan = (engine_mod.fused_content_style_transfer,
                   engine_mod.transfer_decoded)

    def spy_fused(ldm, content, *a, **k):
        calls.append(("fused", content.shape[0]))
        return fused(ldm, content, *a, **k)

    def spy_scan(ldm, content, *a, **k):
        calls.append(("scan", content.shape[0]))
        return scan(ldm, content, *a, **k)
    monkeypatch.setattr(engine_mod, "fused_content_style_transfer",
                        spy_fused)
    monkeypatch.setattr(engine_mod, "transfer_decoded", spy_scan)
    return calls


def test_padding_cropping_and_routes(pair, engine, monkeypatch):
    _, _, _, content, style = pair
    calls = _spy(monkeypatch)
    before = engine.stats()
    out = engine.transfer_batch(content[:3], style[:3], seeds=[1, 2, 3])
    assert out["image"].shape == (3, 128, 128, 1)
    assert out["audio"].shape == (3, 66150)
    assert np.isfinite(out["audio"]).all()
    assert out["image"].min() >= 0.0 and out["image"].max() <= 1.0
    after = engine.stats()
    assert after["padded_slots"] - before["padded_slots"] == 1
    assert after["batches"] - before["batches"] == 1
    engine.transfer_batch(content, style, seeds=np.arange(8))
    assert calls == [("fused", 4), ("scan", 8)]


def test_fused_bucket_max_default(pair, monkeypatch):
    """The fused kernel beat the scan route at every bucket on the card
    (chip_smoke.py), so by default the engine sends it every bucket it
    takes; the environment still overrides."""
    monkeypatch.delenv("MSTLDM_FUSED_BUCKET_MAX", raising=False)
    assert chips.fused_bucket_max() == FUSED_MAX_BATCH == 8
    eng = InferenceEngine(pair[2], EngineConfig(sampler="fused", **QUICK))
    assert [eng.uses_fused(b) for b in (1, 2, 4, 8, 16)] == [
        True, True, True, True, False]
    monkeypatch.setenv("MSTLDM_FUSED_BUCKET_MAX", "2")
    assert chips.fused_bucket_max() == 2


def test_split_above_top_bucket(pair, monkeypatch):
    _, _, port, content, style = pair
    eng = InferenceEngine(port, EngineConfig(
        sampler="ddim", batch_buckets=(1, 2), invert_audio=False,
        match_level=True, **QUICK))
    calls = _spy(monkeypatch)
    out = eng.transfer_batch(content[:3], style[:3], seeds=[5, 6, 7])
    assert out["image"].shape == (3, 128, 128, 1)
    assert "audio" not in out
    # match_level moves each output's level to its style's (up to clipping
    # at [0, 1]).
    np.testing.assert_allclose(out["image"].mean(axis=(1, 2, 3)),
                               style[:3].mean(axis=(1, 2, 3)), atol=0.05)
    # After the warmup of buckets 1 and 2, the 3 requests go as 2 + 1.
    assert calls[-2:] == [("scan", 2), ("scan", 1)]


def test_same_seed_same_output_whatever_the_grouping(pair, engine):
    _, _, _, content, style = pair
    batched = engine.transfer_batch(content[:4], style[:4],
                                    seeds=[10, 11, 12, 13])
    for i in (0, 2):
        alone = engine.transfer_batch(content[i:i + 1], style[i:i + 1],
                                      seeds=[10 + i])
        np.testing.assert_allclose(alone["image"][0], batched["image"][i],
                                   atol=GROUPING_ATOL)
    # ... and across the two routes (fused bucket 4 vs scan bucket 8).
    eight = engine.transfer_batch(content, style, seeds=np.arange(10, 18))
    np.testing.assert_allclose(eight["image"][:4], batched["image"],
                               atol=GROUPING_ATOL)


def test_submit_start_stop_delivers_every_request(pair, engine):
    _, _, _, content, style = pair
    engine.start()
    try:
        waiters = [engine.submit(content[i], style[i], seed=i)
                   for i in range(5)]
        results = [w.get(timeout=300) for w in waiters]
    finally:
        engine.stop()
    for r in results:
        assert not isinstance(r, Exception), r
        assert r["image"].shape == (128, 128, 1)
        assert r["audio"].shape == (66150,)
    assert engine.stats()["pending"] == 0


def test_guidance_needs_scan_sampler(pair):
    _, _, port, _, _ = pair
    with pytest.raises(ValueError, match="needs a scan sampler"):
        InferenceEngine(port, EngineConfig(sampler="fused", guidance=2.0))
