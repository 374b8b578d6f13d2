"""Generation from noise, corpus latent statistics and the port's
checkpoints, against the JAX package on the CPU.

The JAX side's own draw ``jax.random.normal(key, z_shape)`` is injected
as ``noise=``, so both sides walk the same trajectory.  The fused route
is held to the JAX ``fused_style_sample`` with its Pallas kernel in
interpret mode; the port's wrapper takes its plain version because the
tensors lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.models.ldm import (
    corpus_latent_stats as jax_corpus_latent_stats,
)
from music_style_transfer_ldm_tpu.models.ldm import (
    style_ddim_sample as jax_style_sample,
)
from music_style_transfer_ldm_tpu.ops.pallas.fused_sampler import (
    fused_style_sample as jax_fused_style_sample,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    build_ldm, checkpoint_distill_meta, corpus_latent_stats, load_ldm,
    style_ddim_sample,
)
from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
    FORMAT_VERSION, load_checkpoint, save_checkpoint,
)

SAMPLE_ATOL = 1e-4   # decoded images in [0, 1] after a scan trajectory, f32
FUSED_ATOL = 1e-5    # fused plain version vs the JAX kernel, DDIM
DPM_ATOL = 1e-4      # ... DPM++(2M), as tests/test_torch_sampler.py
STEPS = 5            # grid points: 4 updates from t = T-1


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(11)
    model = JaxLDM(dtype=jnp.float32)
    x = jnp.asarray(rng.rand(1, 128, 128, 1), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "diffusion": jax.random.PRNGKey(1)},
                           x, x, jnp.zeros((1,), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_ldm(device="cpu")
    load_flax_variables(port, variables)
    styles = rng.rand(2, 128, 128, 1).astype(np.float32)
    return model, variables, port, styles


def _noise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))


@pytest.mark.parametrize("sampler,guidance,stats", [
    ("ddim", 1.0, False), ("ddim", 2.5, False), ("dpm++", 1.0, False),
    ("ddim", 1.0, True), ("dpm++", 2.5, True)])
def test_style_sample_matches_jax(pair, sampler, guidance, stats):
    model, variables, port, styles = pair
    z_shape = (2, 16, 16, 32)
    latent_stats = None
    if stats:
        rng = np.random.RandomState(3)
        latent_stats = (rng.randn(32).astype(np.float32),
                        (0.5 + rng.rand(32)).astype(np.float32))
    want, _ = jax_style_sample(
        model, variables, jax.random.PRNGKey(4), z_shape,
        jnp.asarray(styles), timesteps=STEPS, sampler=sampler,
        guidance=guidance,
        latent_stats=None if latent_stats is None else tuple(
            jnp.asarray(v) for v in latent_stats))
    got = style_ddim_sample(
        port, z_shape, torch.tensor(styles), timesteps=STEPS,
        sampler=sampler, guidance=guidance, latent_stats=latent_stats,
        noise=torch.tensor(_noise(4, z_shape)))
    assert tuple(got.shape) == (2, 128, 128, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL)


@pytest.mark.parametrize("sampler,guidance", [("ddim", 1.0),
                                              ("dpm++", 1.0),
                                              ("ddim", 2.5)])
def test_style_sample_logs_match_jax(pair, sampler, guidance):
    """return_logs: the per-step pred_x0 and noise_pred of generation, in
    the JAX package's NHWC layout; without it the images alone, as
    before."""
    model, variables, port, styles = pair
    z_shape = (2, 16, 16, 32)
    want, wlogs = jax_style_sample(
        model, variables, jax.random.PRNGKey(5), z_shape,
        jnp.asarray(styles), timesteps=STEPS, sampler=sampler,
        guidance=guidance, return_logs=True)
    noise = torch.tensor(_noise(5, z_shape))
    got, logs = style_ddim_sample(
        port, z_shape, torch.tensor(styles), timesteps=STEPS,
        sampler=sampler, guidance=guidance, noise=noise, return_logs=True)
    alone = style_ddim_sample(
        port, z_shape, torch.tensor(styles), timesteps=STEPS,
        sampler=sampler, guidance=guidance, noise=noise)
    assert torch.equal(alone, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SAMPLE_ATOL)
    np.testing.assert_array_equal(logs["timesteps"].numpy(),
                                  np.asarray(wlogs["timesteps"]))
    for k in ("pred_x0", "noise_pred"):
        assert tuple(logs[k].shape) == (STEPS - 1, *z_shape)
        np.testing.assert_allclose(logs[k].numpy(), np.asarray(wlogs[k]),
                                   atol=SAMPLE_ATOL)


@pytest.mark.parametrize("sampler,batch,atol", [
    ("ddim", 2, FUSED_ATOL), ("dpm++", 1, DPM_ATOL)])
def test_fused_style_sample_matches_jax_kernel(pair, sampler, batch, atol):
    model, variables, port, styles = pair
    z_shape = (batch, 16, 16, 32)
    style = styles[:1]                     # one style shared by the batch
    want = jax_fused_style_sample(model, variables, jax.random.PRNGKey(6),
                                  z_shape, jnp.asarray(style),
                                  timesteps=STEPS, sampler=sampler,
                                  interpret=True)
    before = fs.fused_ddim_sample.launches
    got = fs.fused_style_sample(port, z_shape, torch.tensor(style),
                                timesteps=STEPS, sampler=sampler,
                                noise=torch.tensor(_noise(6, z_shape)))
    assert fs.fused_ddim_sample.launches == before   # plain version ran
    assert tuple(got.shape) == (batch, 128, 128, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_fused_and_scan_generation_share_the_seeded_draw(pair):
    """Without ``noise=`` both routes draw z_T from the same seeded
    generator, so for one seed they walk the same trajectory."""
    _, _, port, styles = pair
    z_shape = (1, 16, 16, 32)
    style = torch.tensor(styles[:1])
    scan = style_ddim_sample(port, z_shape, style, timesteps=STEPS, seed=9)
    fused = fs.fused_style_sample(port, z_shape, style, timesteps=STEPS,
                                  seed=9)
    np.testing.assert_allclose(fused.numpy(), scan.numpy(),
                               atol=SAMPLE_ATOL)
    other = style_ddim_sample(port, z_shape, style, timesteps=STEPS, seed=10)
    assert np.abs(other.numpy() - scan.numpy()).max() > 1e-4
    with pytest.raises(ValueError, match="at most B=8"):
        fs.fused_style_sample(port, (9, 16, 16, 32), style)


def test_corpus_latent_stats_matches_jax(pair):
    model, variables, port, _ = pair
    images = np.random.RandomState(12).rand(5, 128, 128, 1).astype(
        np.float32)
    mu, sigma = corpus_latent_stats(port, images, batch=2)
    want_mu, want_sigma = jax_corpus_latent_stats(model, variables, images,
                                                  batch=2)
    assert tuple(mu.shape) == tuple(sigma.shape) == (32,)
    np.testing.assert_allclose(mu.numpy(), np.asarray(want_mu), atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(want_sigma),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The port's checkpoint format and load_ldm
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip_prefers_ema(tmp_path, capsys):
    raw = build_ldm(device="cpu", seed=1)
    ema = build_ldm(device="cpu", seed=2)
    ema_params = {k: v for k, v in ema.state_dict().items()
                  if k in dict(ema.named_parameters())}
    path = tmp_path / "ckpt.pt"
    save_checkpoint(path, raw, ema_params=ema_params,
                    distill={"steps": 6, "t_max": 50, "stages": [12, 6],
                             "guidance": 1.0})
    payload = load_checkpoint(path)
    assert payload["format_version"] == FORMAT_VERSION == 2
    assert set(payload) == {"params", "ema_params", "distill",
                            "format_version"}
    cfg = default_config()
    got = load_ldm(cfg, str(path), device="cpu", dtype=torch.float32)
    assert "using EMA weights" in capsys.readouterr().out
    state = got.state_dict()
    for k, v in ema.state_dict().items():
        # EMA replaces the parameters; BatchNorm statistics stay raw.
        want = v if k in ema_params else raw.state_dict()[k]
        torch.testing.assert_close(state[k], want, rtol=0, atol=0)
    plain = load_ldm(cfg, str(path), use_ema=False, device="cpu",
                     dtype=torch.float32)
    for k, v in raw.state_dict().items():
        torch.testing.assert_close(plain.state_dict()[k], v, rtol=0, atol=0)
    assert got.dtype == torch.float32 and not got.training
    assert load_ldm(cfg, str(path), device="cpu").dtype == torch.bfloat16
    assert checkpoint_distill_meta(str(path)) == {
        "steps": 6, "t_max": 50, "stages": [12, 6], "guidance": 1.0}


def test_checkpoint_without_ema_or_distill(tmp_path):
    model = build_ldm(device="cpu", seed=3)
    path = tmp_path / "plain.pt"
    save_checkpoint(path, model)
    assert checkpoint_distill_meta(str(path)) is None
    assert checkpoint_distill_meta(str(tmp_path / "missing.pt")) is None
    got = load_ldm(None, str(path), device="cpu", dtype=torch.float32)
    x = torch.tensor(np.random.RandomState(0).rand(1, 128, 128, 1),
                     dtype=torch.float32)
    torch.testing.assert_close(got.encode(x), model.encode(x), rtol=0, atol=0)


def test_checkpoint_refuses_other_files(tmp_path):
    bad = tmp_path / "bad.pt"
    torch.save({"weights": 1}, bad)
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        load_checkpoint(bad)
    old = tmp_path / "old.pt"
    torch.save({"params": {}, "format_version": 1}, old)
    with pytest.raises(ValueError, match="format 1"):
        load_checkpoint(old)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_ldm()
