"""The port's autoencoder phase and its handoff to the LDM phase against
the JAX package's (f32, CPU).

Weights are made on the port's side and carried to the JAX side through
``interop/flax_weights.py`` (the AE's encoder and decoder ride in a port
LDM, whose flax export is cut to those two); the feature metrics' weights
go the same way through ``export_flax_convs``.  On the CPU the kernel
wrappers run their plain versions.
"""

import copy
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.datasets import (
    prepare_dataset as jax_prepare_dataset,
)
from music_style_transfer_ldm_tpu.losses.basic import (
    compression_loss as jax_compression_loss,
)
from music_style_transfer_ldm_tpu.training import AETrainer as JaxAETrainer
from music_style_transfer_ldm_tpu.training.optim import (
    make_optimizer as jax_make_optimizer,
)
from music_style_transfer_ldm_tpu.training.optim import (
    set_learning_rate as jax_set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets import prepare_dataset
from music_style_transfer_ldm_tpu_torch.datasets.loader import BatchLoader
from music_style_transfer_ldm_tpu_torch.losses.basic import compression_loss
from music_style_transfer_ldm_tpu_torch.losses.feature import (
    build_feature_metric,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs, export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.layers import BatchNorm
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm, load_ldm
from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm
from music_style_transfer_ldm_tpu_torch.training import AETrainer, LDMTrainer
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt
from music_style_transfer_ldm_tpu_torch.training.optim import (
    make_optimizer, set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch.utils import profiling
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

RTOL_LOSS = 1e-5      # scalar losses, f32 both sides
GRAD_OF_MAX = 1e-4    # per parameter: max abs error / max |grad|
ATOL_STATS = 1e-6     # BatchNorm running statistics after a step
ZERO_FLOOR = 1e-5     # of the largest gradient: the true gradient is 0
                      # (a conv bias feeding a train-mode BatchNorm)
AE = ("encoder", "decoder")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny(cfg, **train):
    """tests/test_training.py's tiny config: 64x64, B=4, f32."""
    cfg.train = dataclasses.replace(cfg.train, batch_size=4, num_epochs=2,
                                    compute_dtype="float32", **train)
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


def _randomise_stats(module, rng):
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(torch.tensor(0.1 * rng.randn(n)))
                mod.running_var.copy_(torch.tensor(0.5 + rng.rand(n)))


def _holder(cfg):
    """A port LDM to carry an AE's tensors to and from flax layout."""
    return build_ldm(cfg, device="cpu", seed=1)


def _ae_to_flax(model, holder):
    """The port AE (``model.encoder``/``.decoder``) as flax variables,
    copied (the export shares memory with ``holder``, which
    ``_flax_to_port`` overwrites)."""
    for comp in AE:
        getattr(holder, comp).load_state_dict(
            getattr(model, comp).state_dict())
    v = jax.tree_util.tree_map(np.array, export_flax_variables(holder))
    return {kind: {comp: v[kind][comp] for comp in AE}
            for kind in ("params", "batch_stats")}


def _flax_to_port(tree, holder):
    """flax AE params (e.g. gradients) -> {port name: numpy array}."""
    full = export_flax_variables(holder)
    for comp in AE:
        full["params"][comp] = jax.tree_util.tree_map(np.asarray,
                                                      tree[comp])
    load_flax_variables(holder, full)
    return {f"{comp}.{k}": p.detach().numpy().copy()
            for comp in AE
            for k, p in getattr(holder, comp).named_parameters()}


# ---------------- AdamW -------------------------------------------------------


def _adamw_pair(seed):
    rng = np.random.RandomState(seed)
    model = torch.nn.ModuleDict({"a": torch.nn.Conv2d(3, 5, 3),
                                 "b": torch.nn.Linear(7, 4)})
    params = {k: p.detach().numpy().copy()
              for k, p in model.named_parameters()}
    opt = make_optimizer("adamw", list(model.parameters()), 5e-4)
    tx = jax_make_optimizer("adamw", learning_rate=5e-4, weight_decay=0.01)
    return rng, model, params, opt, tx, tx.init(params)


def _adamw_steps(rng, model, params, opt, tx, state, n):
    for _ in range(n):
        grads = {k: rng.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()}
        for k, p in model.named_parameters():
            p.grad = torch.tensor(grads[k])
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _assert_params_equal(model, params):
    for k, p in model.named_parameters():
        # rtol 1e-6, atol 1e-8: the same update in another rounding order
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-6, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_matches_optax(steps):
    rng, model, params, opt, tx, state = _adamw_pair(steps)
    params, _ = _adamw_steps(rng, model, params, opt, tx, state, steps)
    _assert_params_equal(model, params)
    assert opt.param_groups[0]["weight_decay"] == 0.01


def test_adamw_after_set_learning_rate():
    rng, model, params, opt, tx, state = _adamw_pair(7)
    params, state = _adamw_steps(rng, model, params, opt, tx, state, 2)
    set_learning_rate(opt, 1e-5)
    state = jax_set_learning_rate(state, 1e-5)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    params, _ = _adamw_steps(rng, model, params, opt, tx, state, 1)
    _assert_params_equal(model, params)
    # the step moved by the new rate: |dp| <= 1e-5 (1 + wd |p|) + rounding
    for k, p in model.named_parameters():
        assert float((p.detach() - before[k]).abs().max()) < 2e-5, k
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd", list(model.parameters()))


# ---------------- one step against the JAX AETrainer -------------------------

METRICS = {"lpips": ("lpips", True), "vggish": ("vggish", True),
           "none": ("lpips", False)}


def _trainers(metric):
    kind, perceptual = METRICS[metric]
    cfg = tiny(default_config(), compression_feature_extractor=kind)
    port = AETrainer(cfg, perceptual=perceptual, device="cpu")
    jax_tr = JaxAETrainer(tiny(jax_config(),
                               compression_feature_extractor=kind),
                          perceptual=perceptual)
    return cfg, port, jax_tr


def _port_grads(model):
    return {k: p.grad for k, p in model.named_parameters()}


def _assert_grads_close(got, want, names, tol=GRAD_OF_MAX):
    top = max(float(np.abs(w).max()) for w in want.values())
    n = 0
    for name in names:
        g, w = got[name], want[name]
        scale = float(np.abs(w).max())
        if scale < ZERO_FLOOR * top:
            assert float(g.abs().max()) < ZERO_FLOOR * top, name
            continue
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < tol, (name, err)
        n += 1
    assert n >= 5


def _head_partials(trainer, model, x):
    """On a copy of ``model`` (the forward updates its BatchNorm
    statistics): the AE's outputs (z, recon) and the loss head's partial
    gradients in them."""
    z, recon = trainer._forward(copy.deepcopy(model), torch.tensor(x),
                                train=True)
    zi, ri = (t.detach().requires_grad_(True) for t in (z, recon))
    feature = trainer.feature.distance if trainer.feature else None
    compression_loss(torch.tensor(x), (ri + 1.0) / 2.0, zi, feature,
                     trainer.perceptual_weight,
                     trainer.kl_weight).backward()
    return (zi.detach().numpy(), ri.detach().numpy(), zi.grad.numpy(),
            ri.grad.numpy())


def _jax_grads(jtr, variables, x, fparams, holder):
    def loss_fn(params):
        return jtr._loss(params, variables["batch_stats"], x, fparams,
                         train=True)
    _, grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return _flax_to_port(grads, holder)


def _pair_state(metric, seed=3):
    cfg, trainer, jtr = _trainers(metric)
    rng = np.random.RandomState(seed)
    state = trainer.init_state(0)
    _randomise_stats(state.model, rng)
    holder = _holder(cfg)
    variables = _ae_to_flax(state.model, holder)
    jstate = jtr.init_state(0)
    jstate = jstate.replace(params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=jtr.tx.init(variables["params"]))
    fparams = (export_flax_convs(trainer.feature.module)
               if trainer.feature is not None else None)
    x = rng.rand(4, 64, 64, 1).astype(np.float32)
    return cfg, trainer, jtr, state, jstate, holder, variables, fparams, x


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_ae_step_matches_jax(metric):
    """Validation loss, training loss and the updated BatchNorm statistics
    of ``_step`` against the JAX ``_train_step``, and the gradients of the
    step's loss head at the port's activations.

    The whole step's parameter gradients are compared at 1e-4 of max with
    the KL term off and not with LPIPS (the next test), and in relative L2
    with every term on (``test_whole_step_gradients_match_jax_in_norm``).
    The two sides' train-mode
    forwards differ by ~1e-5 (flax's E[x^2] - E[x]^2 batch variance
    summed in other orders), and these two terms turn such differences
    into gradient differences above 1e-4 of a gradient's max, so that
    each side's gradient is set by its own f32 rounding: the KL term's
    z - z / (z^2 + 1e-8) has a slope of up to 1e8 near z = 0, and
    AlexNet's max-pools route LPIPS's gradient by near ties
    (``test_whole_step_gradients_follow_rounding_with_kl_or_lpips``)."""
    (cfg, trainer, jtr, state, jstate, holder, variables, fparams,
     x) = _pair_state(metric)

    # validation: the running statistics, no update, deterministic
    ev = trainer._eval(state, torch.tensor(x))
    assert torch.equal(ev, trainer._eval(state, torch.tensor(x)))
    np.testing.assert_allclose(ev.item(),
                               float(jtr._val_step(jstate, x, fparams)),
                               rtol=RTOL_LOSS)
    after_eval = dict(jax.tree_util.tree_leaves_with_path(
        _ae_to_flax(state.model, holder)["batch_stats"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            variables["batch_stats"]):
        np.testing.assert_array_equal(after_eval[path], leaf)

    # the loss head (MSE, the metric with the reconstruction as its
    # target, KL) at the port's activations: gradients in z and recon
    z, recon, gz, grecon = _head_partials(trainer, state.model, x)

    def head(z, recon):
        feature = (None if jtr.feature is None else
                   lambda a, b, w: jtr.feature.distance(fparams, a, b, w))
        return jax_compression_loss(x, (recon + 1.0) / 2.0, z, feature,
                                    jtr.perceptual_weight, jtr.kl_weight)
    jgz, jgrecon = jax.grad(head, argnums=(0, 1))(z, recon)
    for got, want in ((gz, jgz), (grecon, jgrecon)):
        want = np.asarray(want)
        assert np.abs(got - want).max() < GRAD_OF_MAX * np.abs(want).max()

    # the step: its loss and the updated statistics
    state, loss = trainer._step(state, torch.tensor(x))
    jstate, jloss = jtr._train_step(jstate, x, fparams)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL_LOSS)
    got = dict(jax.tree_util.tree_leaves_with_path(
        _ae_to_flax(state.model, holder)["batch_stats"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jstate.batch_stats):
        np.testing.assert_allclose(got[path], np.asarray(leaf),
                                   atol=ATOL_STATS, err_msg=str(path))
    assert state.step == 1


# With VGGish, the JAX side's f32 statistics of a 64x64x64 layer reach the
# parameter gradients amplified (tests/test_torch_training.py's VGGish
# variant): the port is held to JAX there at that test's 5e-2 and to its own
# float64-statistics oracle at GRAD_OF_MAX.
JAX_GRAD_TOL = {"none": GRAD_OF_MAX, "vggish": 5e-2}


@pytest.mark.parametrize("metric", sorted(JAX_GRAD_TOL))
def test_ae_step_gradients_match_jax(metric, monkeypatch):
    """Every parameter gradient of one step with KL weight 0, against the
    JAX trainer's (see the test above for why not with the KL term, nor
    with LPIPS)."""
    (cfg, trainer, jtr, state, _, holder, variables, fparams,
     x) = _pair_state(metric)
    trainer.kl_weight = jtr.kl_weight = 0.0
    want = _jax_grads(jtr, variables, x, fparams, holder)
    oracle_state = copy.deepcopy(state)
    state, _ = trainer._step(state, torch.tensor(x))
    got = _port_grads(state.model)
    _assert_grads_close(got, want, list(want), JAX_GRAD_TOL[metric])
    monkeypatch.setattr(nm, "STAT_DTYPE", torch.float64)
    oracle_state, _ = trainer._step(oracle_state, torch.tensor(x))
    oracle = {k: v.numpy() for k, v in _port_grads(oracle_state.model).items()}
    _assert_grads_close(got, oracle, list(oracle))


def _rel_l2(got, want):
    """{parameter: ||got - want|| / ||want||}, skipping gradients below
    ZERO_FLOOR of the largest norm (a true gradient of 0)."""
    norms = {k: float(np.linalg.norm(w)) for k, w in want.items()}
    top = max(norms.values())
    return {k: float(np.linalg.norm(np.asarray(got[k]) - w)) / norms[k]
            for k, w in want.items() if norms[k] >= ZERO_FLOOR * top}


# The whole step with every term on (the default config: KL weight 0.01,
# perceptual weight 0.1), per parameter in relative L2.  The KL term's
# gradient z - z / (z^2 + 1e-8) reaches only the encoder; the decoder's
# gradients come from MSE and the metric.  Readings of
# tools/torch_ae_grad_spread.py (CPU, seeds 3-8, alike for LPIPS, VGGish and
# no metric): port vs JAX up to 0.121 on an encoder parameter and 5.7e-3 on
# a decoder one (JAX against itself at a 1e-5 relative change of the input:
# up to 0.92 and 1.2e-2); the port with the KL term dropped is >= 0.976 off
# on the encoder, with the perceptual term dropped >= 0.11 off on the
# decoder.  The limits sit between the two.
REL_L2_ENCODER = 0.3
REL_L2_DECODER = 3e-2


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_whole_step_gradients_match_jax_in_norm(metric):
    """Every parameter gradient of one default step (KL on; LPIPS is the
    default metric) against the JAX trainer's, in relative L2: at 1e-4 of
    max each side's f32 rounding decides (the test below)."""
    (_, trainer, jtr, state, _, holder, variables, fparams,
     x) = _pair_state(metric)
    assert trainer.kl_weight == jtr.kl_weight == 0.01
    want = _jax_grads(jtr, variables, x, fparams, holder)
    state, _ = trainer._step(state, torch.tensor(x))
    err = _rel_l2(_port_grads(state.model), want)
    assert len(err) >= 12
    for name, e in err.items():
        limit = (REL_L2_ENCODER if name.startswith("encoder.")
                 else REL_L2_DECODER)
        assert e < limit, (name, e)


CONDITIONING = {"mse": ("none", 0.0, False), "kl": ("none", 0.01, True),
                "lpips": ("lpips", 0.0, True)}


@pytest.mark.parametrize("case", sorted(CONDITIONING))
def test_whole_step_gradients_follow_rounding_with_kl_or_lpips(case):
    """Why the whole-step gradients above are held at 1e-4 of max only
    without the KL term and LPIPS: multiplying the input by (1 + 1e-6
    noise), a change of the size
    of f32 rounding, moves the port's own step gradients by more than
    GRAD_OF_MAX of their max with either term, and by less with MSE
    alone."""
    metric, kl, sensitive = CONDITIONING[case]
    moved = 0.0
    grads = []
    for eps in (0.0, 1e-6):
        _, trainer, _, state, _, _, _, _, x = _pair_state(metric)
        trainer.kl_weight = kl
        noise = np.random.RandomState(9).randn(*x.shape)
        x = (x * (1.0 + eps * noise)).astype(np.float32)
        state, _ = trainer._step(state, torch.tensor(x))
        grads.append(_port_grads(state.model))
    top = max(float(g.abs().max()) for g in grads[0].values())
    for k, g in grads[0].items():
        scale = float(g.abs().max())
        if scale >= ZERO_FLOOR * top:
            moved = max(moved, float((grads[1][k] - g).abs().max()) / scale)
    assert (moved > GRAD_OF_MAX) == sensitive, moved


def test_ae_trainer_takes_transplanted_feature_weights(tmp_path):
    """AETrainer(feature_params=) from a feature checkpoint (an LPIPS from
    seed 5 stands in for imported weights): the metric holds those weights,
    not seed 0's, and the validation loss is the JAX trainer's with them."""
    cfg, trainer, jtr = _trainers("lpips")
    other = build_feature_metric("lpips", seed=5, device="cpu").module
    ckpt.save_feature_checkpoint(tmp_path / "lpips.pt", "lpips",
                                 other.state_dict())
    loaded = ckpt.load_feature_checkpoint(tmp_path / "lpips.pt")
    moved = AETrainer(cfg, device="cpu", feature_params=loaded["params"])
    held = moved.feature.module.state_dict()
    for k, v in loaded["params"].items():
        assert torch.equal(held[k], v), k
    assert any(not torch.equal(held[k], v) for k, v in
               trainer.feature.module.state_dict().items())
    state = moved.init_state(0)
    holder = _holder(cfg)
    variables = _ae_to_flax(state.model, holder)
    jstate = jtr.init_state(0).replace(params=variables["params"],
                                       batch_stats=variables["batch_stats"])
    x = np.random.RandomState(3).rand(4, 64, 64, 1).astype(np.float32)
    ev = moved._eval(state, torch.tensor(x)).item()
    assert ev != trainer._eval(state, torch.tensor(x)).item()
    np.testing.assert_allclose(
        ev, float(jtr._val_step(jstate, x, export_flax_convs(other))),
        rtol=RTOL_LOSS)


def test_ae_trainer_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AETrainer(tiny(default_config()), perceptual=False)
    assert AETrainer(tiny(default_config()), perceptual=False,
                     device="cpu").device.type == "cpu"


def test_ae_loss_decreases_over_eight_steps():
    trainer = AETrainer(tiny(default_config()), perceptual=False,
                        device="cpu")
    state = trainer.init_state(0)
    x = torch.tensor(np.random.RandomState(4).rand(4, 64, 64, 1)
                     .astype(np.float32))
    losses = []
    for _ in range(8):
        state, loss = trainer._step(state, x)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert state.step == 8


def _png_folder(root, sizes=(("classic", 7), ("rock", 6))):
    rng = np.random.RandomState(8)
    for label, n in sizes:
        (root / label).mkdir(parents=True)
        for i in range(n):
            img = rng.randint(0, 256, (128, 128)).astype(np.uint8)
            (root / label / f"{i:03d}.png").write_bytes(write_png_gray(img))
    return root


def test_prepare_dataset_matches_jax(tmp_path):
    root = _png_folder(tmp_path / "img")
    cfg, jcfg = default_config(), jax_config()
    for c in (cfg, jcfg):
        c.train = dataclasses.replace(c.train, batch_size=4)
    train, test = prepare_dataset(cfg, str(root))
    jtrain, jtest = jax_prepare_dataset(jcfg, str(root))
    np.testing.assert_array_equal(train.indices, jtrain.indices)
    np.testing.assert_array_equal(test.indices, jtest.indices)
    assert (len(train.indices), len(test.indices)) == (10, 3)
    assert train.shuffle and not test.shuffle
    for ours, theirs in ((train, jtrain), (test, jtest)):
        for (a, la), (b, lb) in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)


# ---------------- the loop -----------------------------------------------------


def _image_loaders(n_train=8, n_val=2, seed=5):
    rng = np.random.RandomState(seed)
    data = [(rng.rand(64, 64, 1).astype(np.float32), 0)
            for _ in range(n_train + n_val)]
    train = BatchLoader(data, 4, indices=np.arange(n_train), shuffle=True,
                        seed=0, num_threads=1)
    val = BatchLoader(data, 4, indices=np.arange(n_train, n_train + n_val),
                      shuffle=False, num_threads=1)
    return train, val


def test_train_keeps_the_best_validation_weights_and_plateaus_on_them(
        tmp_path):
    """Scripted validation losses: best at epoch 3, then six worse epochs,
    so the plateau (patience 5) halves the rate at epoch 9; the train loss
    keeps falling, so a plateau on it would not."""
    trainer = AETrainer(tiny(default_config()), perceptual=False,
                        device="cpu")
    scripted = iter([5.0, 4.0, 6.0, 3.0] + [7.0] * 6)
    snapshots = []
    evaluate = trainer._eval

    def spy(state, x):
        evaluate(state, x)
        snapshots.append({k: v.clone() for k, v in
                          state.model.encoder.state_dict().items()})
        return torch.tensor(next(scripted))
    trainer._eval = spy
    train, val = _image_loaders()
    state = trainer.train(train, val, num_epochs=10, out_dir=tmp_path)
    assert state.step == 20 and len(snapshots) == 10
    best = ckpt.load_autoencoder(tmp_path / "pretrained.pt")["params"]
    for k, v in best["encoder"].items():
        assert torch.equal(v, snapshots[3][k]), k
        assert not torch.equal(v, snapshots[4][k]) or "num_batches" in k
    final = ckpt.load_autoencoder(tmp_path / "pretrained_final.pt")["params"]
    for k, v in state.model.decoder.state_dict().items():
        assert torch.equal(final["decoder"][k], v), k
    rows = [r.split(",") for r in
            (tmp_path / "metrics.csv").read_text().splitlines()]
    assert rows[0] == ["epoch", "train_loss", "val_loss", "lr", "seconds"]
    lrs = [float(r[3]) for r in rows[1:]]
    assert lrs == [5e-4] * 9 + [2.5e-4]
    train_losses = [float(r[1]) for r in rows[1:]]
    assert train_losses[-1] < train_losses[0]
    assert [float(r[2]) for r in rows[1:]] == [5.0, 4.0, 6.0, 3.0] + [7.0] * 6
    payload = torch.load(tmp_path / "train_state_final.pt",
                         weights_only=True)
    assert payload["step"] == 20 and "opt_state" in payload


def test_resume_continues_the_step_and_truncates_replayed_rows(tmp_path):
    cfg = tiny(default_config())
    train, val = _image_loaders()
    first = AETrainer(cfg, perceptual=False, device="cpu")
    first.train(train, val, num_epochs=2, out_dir=tmp_path / "a")
    at2 = tmp_path / "step4.pt"
    (tmp_path / "a" / "train_state_final.pt").rename(at2)
    # carry on to 3 epochs, then restart from the 2-epoch state to 4
    AETrainer(cfg, perceptual=False, device="cpu").train(
        train, val, num_epochs=3, out_dir=tmp_path / "a", resume_from=at2)
    assert len((tmp_path / "a" / "metrics.csv").read_text()
               .splitlines()) == 4
    state = AETrainer(cfg, perceptual=False, device="cpu").train(
        train, val, num_epochs=4, out_dir=tmp_path / "a", resume_from=at2)
    assert state.step == 8
    epochs = [float(r.split(",")[0]) for r in
              (tmp_path / "a" / "metrics.csv").read_text().splitlines()[1:]]
    assert epochs == [0.0, 1.0, 2.0, 3.0]
    restored = ckpt.restore_train_state(
        tmp_path / "a" / "train_state_final.pt",
        AETrainer(cfg, perceptual=False, device="cpu").init_state(9))
    assert restored.step == 8
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, restored.model.state_dict()[k]), k


# ---------------- the handoff to the LDM phase --------------------------------


def _trained_ae(cfg, tmp_path):
    trainer = AETrainer(cfg, perceptual=False, device="cpu")
    state = trainer.init_state(3)
    x = torch.tensor(np.random.RandomState(6).rand(4, 64, 64, 1)
                     .astype(np.float32))
    state, _ = trainer._step(state, x)
    path = tmp_path / "ae.pt"
    ckpt.save_autoencoder(path, state.model.encoder, state.model.decoder)
    return state.model, path


def test_ldm_init_state_takes_the_pretrained_autoencoder(tmp_path):
    cfg = tiny(default_config(), ema_decay=0.999)
    ae, path = _trained_ae(cfg, tmp_path)
    trainer = LDMTrainer(cfg, perceptual=False, device="cpu")
    state = trainer.init_state(0, pretrained_autoencoder=ckpt.load_autoencoder(
        path))
    for comp in AE:
        got = getattr(state.model, comp).state_dict()
        for k, v in getattr(ae, comp).state_dict().items():
            assert torch.equal(got[k], v), (comp, k)
            if v.is_floating_point() and "running" not in k:
                assert torch.equal(state.ema_params[f"{comp}.{k}"], v)
    assert not any(p.requires_grad for p in state.model.encoder.parameters())
    enc_before = {k: v.clone() for k, v in
                  state.model.encoder.state_dict().items()}
    rng = np.random.RandomState(7)
    content, style = (torch.tensor(rng.rand(4, 64, 64, 1).astype(np.float32))
                      for _ in range(2))
    state, _ = trainer._step(state, content, style)
    for k, v in state.model.encoder.state_dict().items():
        assert torch.equal(enc_before[k], v), k
    assert not torch.equal(state.model.decoder.deconv1.weight,
                           ae.decoder.deconv1.weight)


LOAD_CASES = ("autoencoder only", "fallback", "raise")


@pytest.mark.parametrize("case", LOAD_CASES)
def test_load_ldm_autoencoder_checkpoint(case, tmp_path, capsys):
    cfg = tiny(default_config())
    ae, path = _trained_ae(cfg, tmp_path)
    corrupt = tmp_path / "corrupt.pt"
    corrupt.write_bytes(b"not a checkpoint")
    kw = {"autoencoder_checkpoint": path} if case != "raise" else {}
    if case != "autoencoder only":
        kw["full_checkpoint"] = str(corrupt)
    if case == "raise":
        with pytest.raises(ckpt.LOAD_ERRORS):
            load_ldm(cfg, device="cpu", dtype=torch.float32, **kw)
        return
    model = load_ldm(cfg, device="cpu", dtype=torch.float32, **kw)
    out = capsys.readouterr().out
    assert ("Falling back to encoder/decoder weights" in out) == (
        case == "fallback")
    for comp in AE:
        got = getattr(model, comp).state_dict()
        for k, v in getattr(ae, comp).state_dict().items():
            assert torch.equal(got[k], v), (comp, k)
    fresh = load_ldm(cfg, device="cpu", dtype=torch.float32)
    for k, v in fresh.unet.state_dict().items():
        assert torch.equal(model.unet.state_dict()[k], v), k
    x = torch.tensor(np.random.RandomState(2).rand(2, 64, 64, 1)
                     .astype(np.float32))
    with torch.no_grad():
        want = ae.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_array_equal(model.encode(x).numpy(), want.numpy())


def test_a_train_state_is_not_an_autoencoder_checkpoint(tmp_path):
    cfg = tiny(default_config())
    trainer = AETrainer(cfg, perceptual=False, device="cpu")
    ckpt.save_train_state(tmp_path / "s.pt", trainer.init_state(0))
    with pytest.raises(ValueError, match="not an autoencoder checkpoint"):
        ckpt.load_autoencoder(tmp_path / "s.pt")
    payload = torch.load(tmp_path / "s.pt", weights_only=True)
    payload["format_version"] = 1
    torch.save(payload, tmp_path / "old.pt")
    with pytest.raises(ValueError, match="checkpoint format 1"):
        ckpt.load_checkpoint(tmp_path / "old.pt")


# ---------------- utilities ---------------------------------------------------


def test_profiling_utilities(tmp_path):
    fired = []
    with profiling.StallWatchdog(timeout_s=0.05, context="test",
                                 on_stall=lambda: fired.append(1)) as wd:
        # fired turns true only after the warning and on_stall are done
        wd.wait(timeout=60)
    assert wd.fired and fired == [1]
    with profiling.StallWatchdog(timeout_s=60) as quiet:
        pass
    assert not quiet.fired
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer:
            pass
    assert timer.summary()["steps"] == 3
    with profiling.trace(tmp_path / "prof"):
        torch.ones(8) @ torch.ones(8)
    assert (tmp_path / "prof" / "trace.json").exists()
    bad = torch.nn.Linear(2, 2)
    with torch.no_grad():
        bad.weight.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="NaN"):
        with profiling.debug_mode():
            bad(torch.ones(1, 2))
    with profiling.debug_mode():
        torch.nn.Linear(2, 2)(torch.ones(1, 2))


# ---------------- CLI -----------------------------------------------------------


def test_cli_trains_the_autoencoder(tmp_path):
    """cli train --model autoencoder at the default config (128x128, B=128,
    LPIPS, f32) for one epoch on the CPU: 13 images split 10 / 3."""
    root = _png_folder(tmp_path / "img")
    out = tmp_path / "ae"
    assert cli.main(["train", "--model", "autoencoder", "--data-root",
                     str(root), "--epochs", "1", "--out-dir", str(out),
                     "--device", "cpu"]) == 0
    for name in ("pretrained.pt", "pretrained_final.pt"):
        params = ckpt.load_autoencoder(out / name)["params"]
        assert set(params) == set(AE)
    assert torch.load(out / "train_state_final.pt",
                      weights_only=True)["step"] == 1
    rows = (out / "metrics.csv").read_text().splitlines()
    assert len(rows) == 2
    values = dict(zip(rows[0].split(","), rows[1].split(",")))
    assert np.isfinite(float(values["train_loss"]))
    assert np.isfinite(float(values["val_loss"]))
    with pytest.raises(SystemExit, match="LDM only"):
        cli.main(["train", "--model", "autoencoder", "--data-root",
                  str(root), "--pretrained-ae", str(out / "pretrained.pt"),
                  "--device", "cpu"])
