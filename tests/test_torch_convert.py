"""tools/convert_jax_checkpoint.py: orbax checkpoints written by the JAX
package's own functions, read back by the port (CPU, f32).

Each kind: a full LDM checkpoint with EMA and one with a distillation
grid, train states after one optimizer update (the LDM trainer's Adam
with the encoder frozen, a distillation stage's Adam over the UNet, the
autoencoder trainer's AdamW), an autoencoder checkpoint, and VGGish and
LPIPS feature checkpoints; and a format-1 checkpoint, refused.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_style_transfer_ldm_tpu import cli as jax_cli
from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.losses.lpips import LPIPS as JaxLPIPS
from music_style_transfer_ldm_tpu.losses.vggish import (
    VGGishFeatures as JaxVGGish,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    vggish_feature_distance as jax_vggish_distance,
)
from music_style_transfer_ldm_tpu.models.ldm import (
    checkpoint_distill_meta as jax_distill_meta,
)
from music_style_transfer_ldm_tpu.models.ldm import load_ldm as jax_load_ldm
from music_style_transfer_ldm_tpu.training import checkpoint as jax_ckpt
from music_style_transfer_ldm_tpu.training.optim import (
    make_optimizer as jax_make_optimizer,
)
from music_style_transfer_ldm_tpu.training.state import (
    TrainState as JaxTrainState,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.losses.lpips import LPIPS
from music_style_transfer_ldm_tpu_torch.losses.vggish import (
    VGGishFeatures, vggish_feature_distance,
)
from music_style_transfer_ldm_tpu_torch.models.layers import BatchNorm
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    build_ldm, checkpoint_distill_meta, load_ldm,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt
from music_style_transfer_ldm_tpu_torch.training.optim import make_optimizer
from music_style_transfer_ldm_tpu_torch.training.state import TrainState
from music_style_transfer_ldm_tpu_torch.training.train_autoencoder import (
    AETrainer,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer

ATOL = 1e-5            # model outputs, f32 both sides (test_torch_models)
RTOL_VALUE = 1e-5      # feature losses, f32 (test_torch_losses)
RTOL_UPDATE = 1e-6     # one optimizer update (test_torch_training's Adam)
ATOL_UPDATE = 1e-8

_spec = importlib.util.spec_from_file_location(
    "convert_jax_checkpoint",
    Path(__file__).resolve().parents[1] / "tools" / "convert_jax_checkpoint.py")
conv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(conv)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tiny(cfg):
    """tests/test_training.py's tiny config: 64x64, f32."""
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


@functools.lru_cache(maxsize=1)
def _variables():
    """Flax variables of a random LDM with random BN statistics."""
    rng = np.random.RandomState(1)
    model = build_ldm(_tiny(default_config()), device="cpu", seed=0)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(torch.tensor(0.1 * rng.randn(n)))
                mod.running_var.copy_(torch.tensor(0.5 + rng.rand(n)))
    return export_flax_variables(model)


def _noisy(tree, seed, scale=0.01):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + scale * rng.randn(*np.shape(a)).astype(
            np.float32), tree)


def _close_trees(got, want, **tol):
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_allclose(flat[path], np.asarray(leaf), **tol)


def _convert(src, out):
    kind = conv.convert(str(src), str(out))
    return kind, torch.load(out, map_location="cpu", weights_only=True)


# ---------------- full LDM checkpoints: forward parity -------------------------


def _forward_pair(jax_model, jax_vars, port):
    rng = np.random.RandomState(2)
    content = rng.rand(2, 64, 64, 1).astype(np.float32)
    style = rng.rand(2, 64, 64, 1).astype(np.float32)
    t = np.asarray([7, 150], np.int32)
    want = jax_model.apply(jax_vars, content, style, t, train=False,
                           rngs={"diffusion": jax.random.PRNGKey(3)})
    with torch.no_grad():
        got = port(torch.tensor(content), torch.tensor(style),
                   torch.tensor(t).long(), train=False,
                   noise=torch.tensor(np.asarray(want["noise"])))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("use_ema", [True, False])
def test_full_checkpoint_with_ema_gives_jax_outputs(tmp_path, use_ema):
    variables = _variables()
    src = tmp_path / "full"
    jax_ckpt.save_pytree(src, {**variables,
                               "ema_params": _noisy(variables["params"], 4),
                               "format_version": np.asarray(2)})
    kind, payload = _convert(src, tmp_path / "full.pt")
    assert kind == "full" and payload["ema_params"] is not None
    cfg = _tiny(jax_config())
    jmodel, jvars = jax_load_ldm(cfg, str(src), dtype=jnp.float32,
                                 use_ema=use_ema)
    port = load_ldm(_tiny(default_config()), str(tmp_path / "full.pt"),
                    use_ema=use_ema, dtype=torch.float32, device="cpu")
    _forward_pair(jmodel, jvars, port)


def test_full_checkpoint_carries_the_distill_grid(tmp_path):
    variables = _variables()
    meta = {"steps": 3, "t_max": 100, "stages": [6, 3], "guidance": 2.0}
    src = tmp_path / "distilled_3"
    jax_ckpt.save_pytree(src, {**variables, "distill": meta,
                               "format_version": np.asarray(2)})
    kind, payload = _convert(src, tmp_path / "d.pt")
    assert kind == "full" and payload["ema_params"] is None
    want = conv._plain(jax_distill_meta(str(src)))
    assert checkpoint_distill_meta(tmp_path / "d.pt") == want == meta
    cfg = _tiny(jax_config())
    jmodel, jvars = jax_load_ldm(cfg, str(src), dtype=jnp.float32)
    port = load_ldm(_tiny(default_config()), str(tmp_path / "d.pt"),
                    dtype=torch.float32, device="cpu")
    _forward_pair(jmodel, jvars, port)


# ---------------- train states: optimizer state resumes ------------------------


def _frozen(comps):
    return lambda p: {k: jax.tree_util.tree_map(lambda _: k in comps, v)
                      for k, v in p.items()}


def _ae_trainer_state(cfg):
    return AETrainer(cfg, perceptual=False, device="cpu").init_state(0)


def _ldm_trainer_state(cfg):
    return LDMTrainer(cfg, perceptual=False, device="cpu").init_state(0)


def _unet_stage_state(cfg):
    model = build_ldm(cfg, dtype=torch.float32, device="cpu", seed=0)
    return TrainState(model, make_optimizer(
        "adam", list(model.unet.parameters()), 1e-4))


# (JAX optimizer, its frozen components, the port's template state)
TRAINERS = {
    "ldm": (lambda: jax_make_optimizer("adam", 5e-4,
                                       freeze_mask=_frozen({"encoder"})),
            {"encoder"}, _ldm_trainer_state),
    "distill": (lambda: jax_make_optimizer(
        "adam", 1e-4, freeze_mask=_frozen({"encoder", "decoder",
                                           "style_encoder"})),
        {"encoder", "decoder", "style_encoder"}, _unet_stage_state),
    "autoencoder": (lambda: jax_make_optimizer("adamw", 5e-4), set(),
                    _ae_trainer_state),
}


def _grads(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.randn(*np.shape(a)).astype(np.float32), params)


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_train_state_resumes_with_jax_optimizer_state(tmp_path, trainer):
    make_tx, frozen, template = TRAINERS[trainer]
    variables = _variables()
    comps = (("encoder", "decoder") if trainer == "autoencoder"
             else tuple(variables["params"]))
    params = {k: variables["params"][k] for k in comps}
    stats = {k: v for k, v in variables["batch_stats"].items() if k in comps}
    tx = make_tx()
    opt_state = tx.init(params)
    updates, opt_state = tx.update(_grads(params, 5), opt_state, params)
    params = optax.apply_updates(params, updates)
    ema = _noisy(params, 6) if trainer == "ldm" else None
    extra = {"done": 1, "head": 0.5} if trainer == "distill" else None
    jax_ckpt.save_train_state(
        tmp_path / "ts", JaxTrainState(params, stats, opt_state,
                                       np.asarray(1), ema), extra=extra)
    kind, payload = _convert(tmp_path / "ts", tmp_path / "ts.pt")
    assert kind == "train_state" and payload["step"] == 1
    assert payload.get("extra") == extra

    cfg = _tiny(default_config())
    state = ckpt.restore_train_state(tmp_path / "ts.pt", template(cfg))
    assert state.step == 1
    _close_trees(export_flax_variables(state.model)["params"], params,
                 rtol=0, atol=0)
    if ema is not None:
        holder = build_ldm(cfg, device="cpu", seed=1)
        holder.load_state_dict(payload["ema_params"], strict=False)
        _close_trees(export_flax_variables(holder)["params"], ema,
                     rtol=0, atol=0)
    # the moments, read back through the inverse transposes, are JAX's
    jax_adam = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")][0]
    by_param = {id(p): n for n, p in state.model.named_parameters()}
    holder = build_ldm(cfg, device="cpu", seed=1) if trainer != \
        "autoencoder" else _ae_trainer_state(cfg).model
    for key, moment in (("exp_avg", jax_adam.mu), ("exp_avg_sq", jax_adam.nu)):
        named = {by_param[id(p)]: s[key]
                 for p, s in state.optimizer.state.items()}
        assert {n.split(".")[0] for n in named} == set(comps) - frozen
        with torch.no_grad():
            for n, p in holder.named_parameters():
                p.copy_(named.get(n, torch.zeros_like(p)))
        got = export_flax_variables(holder)["params"]
        for comp in set(comps) - frozen:
            _close_trees(got[comp], moment[comp], rtol=0, atol=0)
    steps = {float(s["step"]) for s in state.optimizer.state.values()}
    assert steps == {1.0}

    # one more update from the same gradient on both sides
    g2 = _grads(params, 7)
    updates, opt_state = tx.update(g2, opt_state, params)
    params = optax.apply_updates(params, updates)
    grad_holder = holder
    load_flax_variables(grad_holder, {"params": g2, "batch_stats": stats})
    g = dict(grad_holder.named_parameters())
    for name, p in state.model.named_parameters():
        p.grad = (None if name.split(".")[0] in frozen
                  else g[name].detach().clone())
    state.optimizer.step()
    _close_trees(export_flax_variables(state.model)["params"], params,
                 rtol=RTOL_UPDATE, atol=ATOL_UPDATE)


# ---------------- autoencoder and feature checkpoints --------------------------


def test_autoencoder_checkpoint_feeds_pretrained_ae(tmp_path):
    variables = _variables()
    ae = {k: {c: variables[k][c] for c in ("encoder", "decoder")}
          for k in ("params", "batch_stats")}
    jax_ckpt.save_autoencoder(tmp_path / "pretrained",
                              JaxTrainState(ae["params"], ae["batch_stats"],
                                            None, np.asarray(0)))
    kind, _ = _convert(tmp_path / "pretrained", tmp_path / "pretrained.pt")
    assert kind == "autoencoder"
    pre = ckpt.load_autoencoder(tmp_path / "pretrained.pt")
    cfg = _tiny(default_config())
    state = LDMTrainer(cfg, perceptual=False, device="cpu").init_state(
        0, pretrained_autoencoder=pre)
    got = export_flax_variables(state.model)
    for k in ("params", "batch_stats"):
        for comp in ("encoder", "decoder"):
            _close_trees(got[k][comp], ae[k][comp], rtol=0, atol=0)
    # load_ldm's fallback reads it as the JAX package's does
    _, jvars = jax_load_ldm(_tiny(jax_config()), dtype=jnp.float32,
                            autoencoder_checkpoint=str(tmp_path /
                                                       "pretrained"))
    port = load_ldm(cfg, autoencoder_checkpoint=tmp_path / "pretrained.pt",
                    dtype=torch.float32, device="cpu")
    _close_trees(export_flax_variables(port)["params"]["decoder"],
                 jvars["params"]["decoder"], rtol=0, atol=0)


def _torch_vggish_sd(rng):
    sd = {}
    for idx, (cin, cout) in zip((0, 3, 6, 8, 11, 13),
                                ((1, 64), (64, 128), (128, 256), (256, 256),
                                 (256, 512), (512, 512))):
        sd[f"features.{idx}.weight"] = torch.tensor(
            rng.randn(cout, cin, 3, 3) / np.sqrt(9 * cin), dtype=torch.float32)
        sd[f"features.{idx}.bias"] = torch.tensor(0.01 * rng.randn(cout),
                                                  dtype=torch.float32)
    return sd


def _torch_lpips_sd(rng):
    sd = {}
    for key, cin, cout, k in (("net.slice1.0", 3, 64, 11),
                              ("net.slice2.3", 64, 192, 5),
                              ("net.slice3.6", 192, 384, 3),
                              ("net.slice4.8", 384, 256, 3),
                              ("net.slice5.10", 256, 256, 3)):
        sd[f"{key}.weight"] = torch.tensor(
            rng.randn(cout, cin, k, k) / np.sqrt(k * k * cin),
            dtype=torch.float32)
        sd[f"{key}.bias"] = torch.tensor(0.01 * rng.randn(cout),
                                         dtype=torch.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = torch.tensor(rng.rand(1, c, 1, 1),
                                                    dtype=torch.float32)
    return sd


@pytest.mark.parametrize("kind", ["vggish", "lpips"])
def test_feature_checkpoints_give_jax_losses(tmp_path, kind):
    rng = np.random.RandomState(8)
    sd = _torch_vggish_sd(rng) if kind == "vggish" else _torch_lpips_sd(rng)
    torch.save(sd, tmp_path / f"{kind}.pth")
    src = tmp_path / kind
    assert jax_cli.main(["import-torch", f"--{kind}",
                         str(tmp_path / f"{kind}.pth"), "--out",
                         str(src)]) == 0
    got_kind, _ = _convert(src, tmp_path / f"{kind}.pt")
    assert got_kind == "feature"
    payload = ckpt.load_feature_checkpoint(tmp_path / f"{kind}.pt")
    assert payload["kind"] == kind
    jparams = jax_ckpt.restore_pytree(src)["params"]
    size = 16 if kind == "vggish" else 64
    a = rng.rand(2, size, size, 1).astype(np.float32)
    b = rng.rand(2, size, size, 1).astype(np.float32)
    w = np.asarray([1.0, 0.5], np.float32)
    if kind == "vggish":
        module = VGGishFeatures()
        module.load_state_dict(payload["params"])
        got = vggish_feature_distance(module, torch.tensor(a),
                                      torch.tensor(b), torch.tensor(w),
                                      impl="plain").item()
        want = float(jax_vggish_distance(JaxVGGish(dtype=jnp.float32),
                                         jparams, a, b, w, impl="xla"))
    else:
        module = LPIPS()
        module.load_state_dict(payload["params"])
        got = module(torch.tensor(a), torch.tensor(b),
                     torch.tensor(w)).item()
        want = float(JaxLPIPS(dtype=jnp.float32).apply(
            {"params": jparams}, a, b, w))
    np.testing.assert_allclose(got, want, rtol=RTOL_VALUE)


def test_format_1_is_refused(tmp_path):
    variables = _variables()
    jax_ckpt.save_pytree(tmp_path / "old", dict(variables))  # no version
    with pytest.raises(SystemExit, match="format 1.*geometry"):
        conv.convert(str(tmp_path / "old"), str(tmp_path / "old.pt"))
    assert not (tmp_path / "old.pt").exists()


def test_port_names_the_converter_for_an_orbax_directory(tmp_path):
    torch.save({"something": 1}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="convert_jax_checkpoint"):
        ckpt.load_checkpoint(tmp_path / "x.pt")


def test_converter_cli(tmp_path, capsys):
    variables = _variables()
    jax_ckpt.save_pytree(tmp_path / "full", {
        **variables, "format_version": np.asarray(2)})
    assert conv.main([str(tmp_path / "full"), str(tmp_path / "f.pt")]) == 0
    assert "converted full checkpoint" in capsys.readouterr().out
    assert ckpt.load_checkpoint(tmp_path / "f.pt")["format_version"] == 2
