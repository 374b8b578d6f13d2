"""The port's LDM training path against the JAX package's (f32, CPU).

Weights are made on the port's side and carried to the JAX side through
``interop/flax_weights.py``; t, the q-sample noise and the style-drop
mask are fed to both sides (the two RNGs cannot agree).  On the CPU the
kernel wrappers run their plain versions.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.datasets import BatchLoader as JaxLoader
from music_style_transfer_ldm_tpu.datasets import (
    SpectrogramPairDataset as JaxPairs,
)
from music_style_transfer_ldm_tpu.datasets.folder import (
    generate_pairings as jax_generate_pairings,
)
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.training import LDMTrainer as JaxTrainer
from music_style_transfer_ldm_tpu.training.optim import (
    make_optimizer as jax_make_optimizer,
)
from music_style_transfer_ldm_tpu.training.optim import (
    plateau_init as jax_plateau_init,
)
from music_style_transfer_ldm_tpu.training.optim import (
    plateau_update as jax_plateau_update,
)
from music_style_transfer_ldm_tpu.training.state import (
    ema_update as jax_ema_update,
)
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets.folder import (
    SpectrogramDataset, SpectrogramPairDataset, generate_pairings,
)
from music_style_transfer_ldm_tpu_torch.datasets.loader import (
    BatchLoader, train_test_split,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs, export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.layers import BatchNorm
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm, load_ldm
from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt
from music_style_transfer_ldm_tpu_torch.training.metrics import MetricLogger
from music_style_transfer_ldm_tpu_torch.training.optim import (
    freeze_encoder, make_optimizer, plateau_init, plateau_update,
    set_learning_rate,
)
from music_style_transfer_ldm_tpu_torch.training.state import (
    as_unit_images, count_params, ema_params_of, ema_update,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import LDMTrainer
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

ATOL = 1e-5           # model outputs, f32 both sides (test_torch_models)
RTOL_LOSS = 1e-5      # scalar losses
GRAD_OF_MAX = 1e-4    # per parameter: max abs error / max |grad|


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


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def _randomise_stats(model, rng):
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(torch.tensor(0.1 * rng.randn(n)))
                mod.running_var.copy_(torch.tensor(0.5 + rng.rand(n)))


# ---------------- BatchNorm, training forward --------------------------------


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(train):
    rng = np.random.RandomState(0)
    x = (2.0 + 3.0 * rng.randn(4, 8, 8, 16)).astype(np.float32)
    scale, bias = rng.rand(16) + 0.5, rng.randn(16)
    mean, var = rng.randn(16), rng.rand(16) + 0.5
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                       variables)
    want, upd = bn.apply(variables, x, mutable=["batch_stats"])
    port = BatchNorm(16)
    with torch.no_grad():
        for t, a in ((port.weight, scale), (port.bias, bias),
                     (port.running_mean, mean), (port.running_var, var)):
            t.copy_(torch.tensor(a))
    got = port(torch.tensor(x).permute(0, 3, 1, 2), train=train)
    _close(got.permute(0, 2, 3, 1).detach(), want)
    new = upd["batch_stats"] if train else variables["batch_stats"]
    _close(port.running_mean, new["mean"], atol=1e-6)
    _close(port.running_var, new["var"], atol=1e-6)


@functools.lru_cache(maxsize=1)
def _pair():
    """A port LDM (64x64 geometry) with random BN statistics, and its
    variables in flax layout."""
    rng = np.random.RandomState(1)
    cfg = tiny(default_config())
    model = build_ldm(cfg, device="cpu", seed=0)
    _randomise_stats(model, rng)
    return cfg, model, export_flax_variables(model)


def _batch(seed=2, B=4, size=64):
    rng = np.random.RandomState(seed)
    content = rng.rand(B, size, size, 1).astype(np.float32)
    style = rng.rand(B, size, size, 1).astype(np.float32)
    t = np.asarray([3, 50, 120, 199][:B], np.int32)
    return content, style, t


@pytest.mark.parametrize("drop", [None, [1.0, 0.0, 0.0, 1.0]])
def test_training_forward_matches_jax(drop):
    cfg, model, variables = _pair()
    content, style, t = _batch()
    jmodel = JaxLDM(dtype=jnp.float32)
    mask = None if drop is None else np.asarray(drop, np.float32)
    want, upd = jmodel.apply(variables, content, style, t, train=True,
                             frozen_encoder=True, style_drop_mask=mask,
                             rngs={"diffusion": jax.random.PRNGKey(4)},
                             mutable=["batch_stats"])
    port = build_ldm(cfg, device="cpu", seed=0)
    load_flax_variables(port, variables)
    with torch.no_grad():
        got = port(torch.tensor(content), torch.tensor(style),
                   torch.tensor(t).long(), train=True, frozen_encoder=True,
                   style_drop_mask=None if mask is None else torch.tensor(
                       mask), noise=torch.tensor(np.asarray(want["noise"])))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k])
    stats = export_flax_variables(port)["batch_stats"]
    for comp in ("encoder", "decoder"):
        flat = dict(jax.tree_util.tree_leaves_with_path(stats[comp]))
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                upd["batch_stats"][comp]):
            _close(flat[path], leaf, atol=1e-6)


# ---------------- _losses: values and gradients ------------------------------

VARIANTS = {"defaults": {},
            "style-grad+vggish-compression": {
                "style_loss_stop_gradient": False,
                "compression_feature_extractor": "vggish"}}
# With the VGGish gradient on, the error of the JAX side's f32 sums over
# a 64x64x64 layer (tests/test_torch_losses.py) reaches the parameter
# gradients amplified, to percents of a gradient's max, while the port's
# stay within GRAD_OF_MAX of those from float64 metric statistics.  So
# that variant is held to JAX at 5e-2 and to the float64 oracle at
# GRAD_OF_MAX.
GRAD_TOL = {"defaults": GRAD_OF_MAX, "style-grad+vggish-compression": 5e-2}
ZERO_FLOOR = 1e-5   # of the largest gradient: the true gradient is 0
                    # (a bias feeding a train-mode BatchNorm)


def _port_losses(variant, variables, batch, noise):
    trainer = LDMTrainer(tiny(default_config(), **VARIANTS[variant]),
                         device="cpu")
    port = build_ldm(trainer.config, device="cpu", seed=0)
    load_flax_variables(port, variables)
    freeze_encoder(port)
    content, style, t = batch
    total, metrics = trainer._losses(
        port, torch.tensor(content), torch.tensor(style),
        torch.tensor(t).long(), noise=torch.tensor(np.asarray(noise)))
    total.backward()
    grads = {k: p.grad for k, p in port.named_parameters()}
    return trainer, metrics, grads


def _assert_grads_close(got, want, tol):
    top = max(float(np.abs(w).max()) for w in want.values())
    n = 0
    for name, g in got.items():
        if name.startswith("encoder."):
            assert g is None, name
            continue
        w = want[name]
        scale = float(np.abs(w).max())
        if scale < ZERO_FLOOR * top:
            assert float(g.abs().max()) < ZERO_FLOOR * top, name
            continue
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err < tol, (name, err)
        n += 1
    assert n > 20


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_losses_values_and_grads_match_jax(variant, monkeypatch):
    _, _, variables = _pair()
    batch = _batch()
    jtrainer = JaxTrainer(tiny(jax_config(), **VARIANTS[variant]),
                          perceptual=True)
    drng = jax.random.PRNGKey(5)
    content, style, t = batch
    noise = jtrainer.model.apply(
        variables, content, style, t, train=True, frozen_encoder=True,
        rngs={"diffusion": drng}, mutable=["batch_stats"])[0]["noise"]
    trainer, got, grads = _port_losses(variant, variables, batch, noise)
    feature_params = (export_flax_convs(trainer.compression_feature.module),
                      export_flax_convs(trainer.style_feature.module))

    def loss_fn(params, stats, c, s, tt):
        return jtrainer._losses(params, stats, c, s, tt, drng,
                                feature_params)

    (_, (metrics, _)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"],
                                variables["batch_stats"], content, style, t)
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=RTOL_LOSS,
                                   err_msg=k)
    holder = build_ldm(trainer.config, device="cpu", seed=1)
    load_flax_variables(holder, {"params": jgrads,
                                 "batch_stats": variables["batch_stats"]})
    want = {k: p.detach().numpy() for k, p in holder.named_parameters()}
    _assert_grads_close(grads, want, GRAD_TOL[variant])
    monkeypatch.setattr(nm, "STAT_DTYPE", torch.float64)
    _, _, oracle = _port_losses(variant, variables, batch, noise)
    _assert_grads_close(grads, {k: v.numpy() for k, v in oracle.items()
                                if v is not None}, GRAD_OF_MAX)


# ---------------- optimizer, EMA, plateau ------------------------------------


def test_adam_step_matches_optax_with_the_encoder_frozen():
    cfg, _, variables = _pair()
    rng = np.random.RandomState(6)
    port = build_ldm(cfg, device="cpu", seed=0)
    load_flax_variables(port, variables)
    opt = make_optimizer("adam", freeze_encoder(port), 5e-4)
    tx = jax_make_optimizer("adam", learning_rate=5e-4, freeze_mask=lambda p: {
        k: jax.tree_util.tree_map(lambda _: k == "encoder", v)
        for k, v in p.items()})
    params = variables["params"]
    state = tx.init(params)
    holder = build_ldm(cfg, device="cpu", seed=1)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda a: rng.randn(*np.shape(a)).astype(np.float32), params)
        load_flax_variables(holder, {"params": grads,
                                     "batch_stats": variables["batch_stats"]})
        g = dict(holder.named_parameters())
        for name, p in port.named_parameters():
            p.grad = None if name.startswith("encoder.") else g[name].clone()
        opt.step()
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    got = export_flax_variables(port)["params"]
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_allclose(flat[path], np.asarray(leaf), rtol=1e-6,
                                   atol=1e-8)
    np.testing.assert_array_equal(
        got["encoder"]["conv1"]["kernel"],
        variables["params"]["encoder"]["conv1"]["kernel"])
    set_learning_rate(opt, 1e-5)
    assert all(grp["lr"] == 1e-5 for grp in opt.param_groups)


@pytest.mark.parametrize("step", [0, 5, 100000])
def test_ema_update_matches_jax(step):
    rng = np.random.RandomState(step)
    model = torch.nn.Linear(7, 3)
    ema = {k: torch.tensor(rng.randn(*p.shape).astype(np.float32))
           for k, p in model.named_parameters()}
    want = jax_ema_update({k: v.numpy() for k, v in ema.items()},
                          {k: p.detach().numpy()
                           for k, p in model.named_parameters()},
                          0.999, jnp.int32(step))
    got = ema_update(ema, model, 0.999, step)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    assert ema_params_of(model)["weight"].dtype == torch.float32


def test_plateau_and_small_helpers():
    s, j = plateau_init(1.0, 0.5, 2, 0.1), jax_plateau_init(1.0, 0.5, 2, 0.1)
    for m in [5.0, 4.0, 3.0, 3.0, 3.0, 3.0] + [99.0] * 20:
        s, j = plateau_update(s, m), jax_plateau_update(j, m)
        assert s.lr == j.lr and s.bad_epochs == j.bad_epochs
    assert s.lr == pytest.approx(0.1)
    u8 = torch.tensor([[0, 255]], dtype=torch.uint8)
    np.testing.assert_array_equal(as_unit_images(u8).numpy(), [[0.0, 1.0]])
    assert count_params(torch.nn.Linear(7, 3)) == 24
    with pytest.raises(ValueError, match="not ported"):
        make_optimizer("adamw", [torch.nn.Parameter(torch.zeros(1))])


# ---------------- trainer, checkpoints, data, CLI ----------------------------


def _pair_ds(rng, n=8, size=64):
    class PairDS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return ((rng.rand(size, size, 1).astype(np.float32), "a"),
                    (rng.rand(size, size, 1).astype(np.float32), "b"))
    return PairDS()


def test_step_freezes_encoder_and_updates_the_rest():
    trainer = LDMTrainer(tiny(default_config()), perceptual=False,
                         device="cpu")
    state = trainer.init_state(0)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    content, style, _ = _batch()
    state, metrics = trainer._step(state, torch.tensor(content),
                                   torch.tensor(style))
    assert state.step == 1 and set(metrics) == {
        "total_loss", "compression_loss", "denoising_loss", "style_loss"}
    assert np.isfinite(metrics["total_loss"].item())
    after = state.model.state_dict()
    for k, v in before.items():
        if k.startswith("encoder."):
            assert torch.equal(v, after[k]), k
    assert not torch.equal(before["unet.enc1.weight"],
                           after["unet.enc1.weight"])
    assert not torch.equal(before["decoder.bn1.running_mean"],
                           after["decoder.bn1.running_mean"])


def test_train_loop_checkpoints_and_resume(tmp_path):
    cfg = tiny(default_config(), ema_decay=0.999)
    rng = np.random.RandomState(3)
    trainer = LDMTrainer(cfg, perceptual=False, device="cpu")
    loader = BatchLoader(_pair_ds(rng), 4, shuffle=False, num_threads=1)
    state = trainer.train(loader, num_epochs=1, out_dir=tmp_path / "a")
    assert state.step == 2
    final = tmp_path / "a" / "ldm_final.pt"
    assert final.exists() and (tmp_path / "a" / "ldm_0.pt").exists()
    assert (tmp_path / "a" / "metrics.csv").exists()

    # the train state round-trips exactly
    fresh = LDMTrainer(cfg, perceptual=False, device="cpu").init_state(5)
    restored = ckpt.restore_train_state(final, fresh)
    assert restored.step == 2
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k in state.ema_params:
        assert torch.equal(state.ema_params[k], restored.ema_params[k])
    sa = state.optimizer.state_dict()["state"]
    sb = restored.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert torch.equal(sa[i]["exp_avg_sq"], sb[i]["exp_avg_sq"])

    # inference reads it as it is: EMA by default, raw on request
    ema_model = load_ldm(cfg, str(final), device="cpu", dtype=torch.float32)
    raw_model = load_ldm(cfg, str(final), use_ema=False, device="cpu",
                         dtype=torch.float32)
    np.testing.assert_array_equal(
        ema_model.unet.enc1.weight.detach().numpy(),
        state.ema_params["unet.enc1.weight"].numpy())
    np.testing.assert_array_equal(
        raw_model.unet.enc1.weight.detach().numpy(),
        state.model.unet.enc1.weight.detach().numpy())

    # resume continues the epoch count from the restored step
    again = LDMTrainer(cfg, perceptual=False, device="cpu")
    state3 = again.train(loader, num_epochs=3, out_dir=tmp_path / "b",
                         resume_from=final)
    assert state3.step == 6
    done = LDMTrainer(cfg, perceptual=False, device="cpu")
    assert done.train(loader, num_epochs=1, out_dir=tmp_path / "c",
                      resume_from=final).step == 2
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt.save_checkpoint(tmp_path / "plain.pt", build_ldm(device="cpu"))
        ckpt.restore_train_state(tmp_path / "plain.pt", fresh)


def test_resumed_run_draws_what_the_uninterrupted_run_drew(tmp_path):
    """2 steps, then 2 more resumed from ldm_0.pt, against 4 steps in one
    run: the same t, noise and style-drop draws at every step (each
    step's generator is seeded from (seed, step)), and the same
    parameters at the end."""
    cfg = tiny(default_config(), style_dropout=0.5)
    rng = np.random.RandomState(4)
    data = [((rng.rand(64, 64, 1).astype(np.float32), "a"),
             (rng.rand(64, 64, 1).astype(np.float32), "b"))
            for _ in range(8)]
    loader = BatchLoader(data, 4, shuffle=False, num_threads=1)

    def run(**kw):
        trainer = LDMTrainer(cfg, perceptual=False, device="cpu")
        draws, losses = [], trainer._losses

        def spy(model, content, style, t, noise=None, style_drop_mask=None):
            draws.append((t.clone(), noise.clone(), style_drop_mask.clone()))
            return losses(model, content, style, t, noise, style_drop_mask)
        trainer._losses = spy
        return trainer.train(loader, **kw), draws

    full, d_full = run(num_epochs=2, out_dir=tmp_path / "full")
    _, d_first = run(num_epochs=1, out_dir=tmp_path / "first")
    resumed, d_rest = run(num_epochs=2, out_dir=tmp_path / "rest",
                          resume_from=tmp_path / "first" / "ldm_0.pt")
    assert len(d_full) == 4 and (len(d_first), len(d_rest)) == (2, 2)
    for step, (a, b) in enumerate(zip(d_full, d_first + d_rest)):
        for name, x, y in zip(("t", "noise", "style_drop_mask"), a, b):
            assert torch.equal(x, y), (step, name)
    assert not torch.equal(d_full[0][1], d_full[2][1])  # steps differ
    assert full.step == resumed.step == 4
    got = resumed.model.state_dict()
    for k, v in full.model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_metric_logger_resume_truncates_replayed_epochs(tmp_path):
    path = tmp_path / "metrics.csv"
    first = MetricLogger(path)
    for e in range(6):
        first.log(epoch=e, loss=float(10 - e))
    resumed = MetricLogger(path, resume=True, truncate_from_epoch=3)
    assert [r["epoch"] for r in resumed.rows] == [0.0, 1.0, 2.0]
    resumed.log(epoch=3, loss=6.5, lr=1e-4)
    resumed.log(epoch=4, loss=6.0, lr=1e-4)
    reread = MetricLogger(path, resume=True)
    assert [r["epoch"] for r in reread.rows] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert reread.rows[-1]["lr"] == 1e-4 and reread.rows[0]["lr"] == ""


def _png_folder(root, sizes=(("classic", 3), ("rock", 2))):
    rng = np.random.RandomState(8)
    for label, n in sizes:
        (root / label).mkdir(parents=True)
        for i in range(n):
            h, w = (128, 160) if i % 2 else (120, 128)   # crop and pad
            img = rng.randint(0, 256, (h, w)).astype(np.uint8)
            (root / label / f"{i:03d}.png").write_bytes(write_png_gray(img))
    return root


def test_pairings_datasets_and_loader_match_jax(tmp_path):
    root = _png_folder(tmp_path / "img")
    generate_pairings(root, tmp_path / "port.csv", num_pairs=20)
    jax_generate_pairings(root, tmp_path / "jax.csv", num_pairs=20)
    assert ((tmp_path / "port.csv").read_bytes()
            == (tmp_path / "jax.csv").read_bytes())
    port = SpectrogramPairDataset(root, tmp_path / "port.csv")
    ref = JaxPairs(root, tmp_path / "jax.csv")
    assert len(port) == len(ref) == 20
    for i in (0, 7, 19):
        (a, la), (b, lb) = port[i]
        (ja, jla), (jb, jlb) = ref[i]
        assert (la, lb) == (jla, jlb)
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
    single = SpectrogramDataset(root)
    assert len(single) == 5 and single.classes == ["classic", "rock"]
    for threads in (1, 3):
        got = list(BatchLoader(port, 6, seed=4, num_threads=threads))
        want = list(JaxLoader(ref, 6, seed=4, num_threads=threads))
        assert len(got) == len(want) == 4
        for (ca, la), (cb, lb) in zip(got, want):
            np.testing.assert_array_equal(ca[0], cb[0])
            assert list(ca[1]) == list(cb[1])
    tr, te = train_test_split(10, 0.8, seed=1)
    assert len(tr) == 8 and sorted(np.concatenate([tr, te])) == list(
        range(10))


def test_cli_trains_and_transfers_from_the_checkpoint(tmp_path):
    """cli train --model ldm at the default config (full width, 128x128,
    batch 128, so one step over two pairs) on the CPU, then cli transfer
    from ldm_final.pt, then a resume."""
    root = _png_folder(tmp_path / "img")
    pairs = tmp_path / "pairs.csv"
    assert cli.main(["generate-pairings", "--root", str(root), "--output",
                     str(pairs), "--num-pairs", "2"]) == 0
    out = tmp_path / "run"
    args = ["train", "--model", "ldm", "--data-root", str(root),
            "--pairing-file", str(pairs), "--out-dir", str(out),
            "--device", "cpu"]
    assert cli.main(args + ["--epochs", "1"]) == 0
    final = out / "ldm_final.pt"
    assert final.exists()
    assert cli.main(["transfer", "--checkpoint", str(final), "--content",
                     str(root / "classic" / "000.png"), "--style",
                     str(root / "rock" / "000.png"), "--steps", "2",
                     "--output", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert (tmp_path / "t.png").exists() and (tmp_path / "t.wav").exists()
    assert cli.main(args + ["--epochs", "2", "--resume-from",
                            str(final)]) == 0
    assert torch.load(final, weights_only=True)["step"] == 2
    for extra in (["--pretrained-ae", "ae"], ["--style-features", "v"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            cli.main(args + extra)
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["train", "--model", "autoencoder", "--device", "cpu"])
