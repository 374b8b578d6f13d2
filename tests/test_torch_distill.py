"""The port's progressive distillation against the JAX package's (f32,
CPU).

Weights are made on the port's side and carried to the JAX side through
``interop/flax_weights.py``.  The two RNGs cannot agree, so the port is
fed the segment indices and noise that the JAX step draws from its key.
The JAX step's gradient is read through its optimizer: ``make_optimizer``
inside the JAX distill module is swapped, from this test only, for a
transformation that returns zero updates and keeps the gradient as its
state (an SGD step of rate 1 would read it as a parameter difference,
which loses gradients far below the parameters' ulp).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_style_transfer_ldm_tpu import cli as jax_cli
from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.parallel import make_mesh
from music_style_transfer_ldm_tpu.training import distill as jax_distill
from music_style_transfer_ldm_tpu.training.state import (
    TrainState as JaxTrainState,
)
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    build_ldm, checkpoint_distill_meta, content_style_transfer, load_ldm,
)
from music_style_transfer_ldm_tpu_torch.training import ProgressiveDistiller
from music_style_transfer_ldm_tpu_torch.training.checkpoint import (
    save_checkpoint,
)
from music_style_transfer_ldm_tpu_torch.training.distill import (
    ddim_step, distill_stage_grids, solve_x0_target, student_steps,
)
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray

RTOL_LOSS = 1e-5       # the stage loss, f32 both sides
GRAD_OF_MAX = 1e-4     # UNet gradients: max abs error / the JAX max
FROZEN = ("encoder", "decoder", "style_encoder")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny(cfg):
    """tests/test_distill.py's tiny config: 64x64 images, B=8, f32."""
    cfg.train = dataclasses.replace(cfg.train, batch_size=8,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


def _batches(n=2, seed=0, size=64, batch=8):
    rng = np.random.RandomState(seed)
    return [((rng.rand(batch, size, size, 1).astype(np.float32), [0] * batch),
             (rng.rand(batch, size, size, 1).astype(np.float32), [0] * batch))
            for _ in range(n)]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _same(a: dict, b: dict, prefix: str) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a if k.startswith(prefix))


# ---------------- target algebra and grids ---------------------------------


@pytest.fixture(scope="module")
def algebra():
    rng = np.random.RandomState(3)
    z_t = rng.randn(4, 8, 8, 2).astype(np.float32)
    z_ss = rng.randn(4, 8, 8, 2).astype(np.float32)
    eps = rng.randn(4, 8, 8, 2).astype(np.float32)
    ab_t = rng.uniform(0.05, 0.6, (4, 1, 1, 1)).astype(np.float32)
    ab_s = ab_t + rng.uniform(0.05, 0.3, (4, 1, 1, 1)).astype(np.float32)
    return z_t, z_ss, eps, ab_t, ab_s


def test_ddim_step_matches_jax(algebra):
    z_t, _, eps, ab_t, ab_s = algebra
    got = ddim_step(*(torch.tensor(a) for a in (z_t, eps, ab_t, ab_s)))
    want = jax_distill.ddim_step(*(jnp.asarray(a)
                                   for a in (z_t, eps, ab_t, ab_s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_solve_x0_target_matches_jax(algebra):
    z_t, z_ss, _, ab_t, ab_s = algebra
    got = solve_x0_target(*(torch.tensor(a) for a in (z_t, z_ss, ab_t, ab_s)))
    want = jax_distill.solve_x0_target(*(jnp.asarray(a)
                                         for a in (z_t, z_ss, ab_t, ab_s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_solve_x0_target_inverts_one_ddim_step(algebra):
    """ddim_step(z_t, eps(x0*)) lands on z_ss."""
    z_t, z_ss, _, ab_t, ab_s = (torch.tensor(a) for a in algebra)
    x0 = solve_x0_target(z_t, z_ss, ab_t, ab_s)
    eps = (z_t - torch.sqrt(ab_t) * x0) / torch.sqrt(1.0 - ab_t)
    np.testing.assert_allclose(ddim_step(z_t, eps, ab_t, ab_s).numpy(),
                               z_ss.numpy(), atol=1e-5)


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("t_max", [50, 100, 200])
@pytest.mark.parametrize("cascade", [(96, 48, 24, 12, 6), (48, 24, 12, 6, 3)])
def test_distill_stage_grids_match_jax(t_max, cascade):
    """Every stage of the cascade (factors 2 and, at the end of the odd
    one, 3) gives JAX's grids, or JAX's error."""
    assert student_steps(cascade) == {
        96: [48, 24, 12, 6, 3], 48: [24, 12, 6, 3, 1]}[cascade[0]]
    for n, s in zip(cascade, student_steps(cascade)):
        got = _outcome(distill_stage_grids, t_max, n, n // s)
        want = _outcome(jax_distill.distill_stage_grids, t_max, n, n // s)
        assert got[0] == want[0], (n, s, got, want)
        if got[0] == "error":
            assert got[1] == want[1]
        else:
            for g, w in zip(got[1], want[1]):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("args", [(100, 7, 2), (50, 4, 3), (50, 4, 1),
                                  (100, 8, 0), (50, 60, 2)])
def test_distill_stage_grids_raise_as_jax(args):
    got, want = (_outcome(fn, *args) for fn in (
        distill_stage_grids, jax_distill.distill_stage_grids))
    assert got == want and got[0] == "error"


def test_stage_counts_raise_as_jax(tmp_path):
    """A cascade whose factors are not integers >= 2 is refused before
    anything runs, with JAX's message."""
    for stages in ((4, 3), (4, 4), (6, 4)):
        with pytest.raises(ValueError) as got:
            ProgressiveDistiller(tiny(default_config()), device="cpu").distill(
                build_ldm(tiny(default_config()), device="cpu"), [],
                stages=stages, out_dir=tmp_path)
        jd = jax_distill.ProgressiveDistiller(tiny(jax_config()),
                                              mesh=make_mesh((-1, 1)))
        with pytest.raises(ValueError) as want:
            jd.distill({"params": {}, "batch_stats": {}}, [], stages=stages,
                       out_dir=tmp_path)
        assert str(got.value) == str(want.value)


def test_t_max_defaults_to_the_config():
    cfg = tiny(default_config())
    jd = jax_distill.ProgressiveDistiller(tiny(jax_config()),
                                          mesh=make_mesh((-1, 1)))
    assert ProgressiveDistiller(cfg, device="cpu").t_max == jd.t_max \
        == cfg.diffusion.transfer_timesteps
    assert ProgressiveDistiller(cfg, t_max=40, device="cpu").t_max == 40


# ---------------- one stage step against JAX's _stage_step_fn --------------


@pytest.fixture(scope="module")
def jax_step_setup():
    cfg = tiny(default_config())
    port = build_ldm(cfg, device="cpu", seed=0)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       export_flax_variables(port))
    rng = np.random.RandomState(1)
    content = rng.rand(8, 64, 64, 1).astype(np.float32)
    style = rng.rand(8, 64, 64, 1).astype(np.float32)
    jd = jax_distill.ProgressiveDistiller(tiny(jax_config()),
                                          mesh=make_mesh((-1, 1)), t_max=100)
    return cfg, variables, content, style, jd


def _capture_grads(*args, **kwargs):
    """An optax transformation whose state after a step is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("n_teacher,factor,guidance",
                         [(4, 2, 1.0), (3, 3, 1.0), (4, 2, 2.0)],
                         ids=["factor2", "factor3", "guided"])
def test_stage_step_matches_jax(jax_step_setup, monkeypatch, n_teacher,
                                factor, guidance):
    cfg, variables, content, style, jd = jax_step_setup
    monkeypatch.setattr(jax_distill, "make_optimizer", _capture_grads)
    grid, _ = distill_stage_grids(100, n_teacher, factor)
    step, tx = jd._stage_step_fn(grid, 1e-3, factor, guidance=guidance)
    # the step donates its state: give it copies
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = JaxTrainState(
        params=params, batch_stats=jax.tree_util.tree_map(
            jnp.array, variables["batch_stats"]),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(5)
    new_state, metrics = step(state, variables["params"],
                              jnp.asarray(content), jnp.asarray(style), key)
    # the JAX step's draws (its `ikey, nkey = jax.random.split(key)`)
    ikey, nkey = jax.random.split(key)
    segment = np.asarray(jax.random.randint(ikey, (8,), 0,
                                            n_teacher // factor))
    noise = np.asarray(jax.random.normal(nkey, (8, 8, 8, 32), jnp.float32))

    dist = ProgressiveDistiller(cfg, device="cpu")
    student = build_ldm(cfg, device="cpu", seed=0)
    student.unet.requires_grad_(True)
    teacher = build_ldm(cfg, device="cpu", seed=0)
    loss = dist.stage_loss(student, teacher, grid, factor, guidance,
                           torch.tensor(content), torch.tensor(style),
                           torch.tensor(segment), torch.tensor(noise))
    loss.backward()
    want = float(metrics["distill_loss"])
    assert abs(loss.item() - want) <= RTOL_LOSS * abs(want), (loss, want)

    holder = build_ldm(cfg, device="cpu", seed=0)
    load_flax_variables(holder, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              variables["batch_stats"])})
    want_g = dict(holder.unet.named_parameters())
    top = max(v.abs().max().item() for v in want_g.values())
    checked = 0
    for name, p in student.unet.named_parameters():
        scale = want_g[name].abs().max().item()
        err = (p.grad - want_g[name]).abs().max().item()
        if scale == 0.0:      # a dead path at this random init, both sides
            assert err <= GRAD_OF_MAX * top, name
            continue
        assert err <= GRAD_OF_MAX * scale, (name, err / scale)
        checked += 1
    assert checked >= 20
    assert all(p.grad is None for m in FROZEN
               for p in getattr(student, m).parameters())


def test_autocast_leaves_the_target_algebra_in_float32(jax_step_setup):
    """Under bf16 autocast (the card's compute type) the loss, with its
    target solve at the lowest-noise segment (w_snr in the thousands), is
    f32 and finite."""
    cfg, _, content, style, _ = jax_step_setup
    dist = ProgressiveDistiller(cfg, device="cpu")
    dist.compute_dtype = torch.bfloat16
    student = build_ldm(cfg, device="cpu", seed=0)
    student.unet.requires_grad_(True)
    grid, _ = distill_stage_grids(100, 96, 2)
    ab = student.schedule.alpha_bars
    assert (ab[grid[94]] / (1 - ab[grid[94]])).item() > 1e3   # t = 2
    noise = torch.randn(8, 8, 8, 32, generator=torch.Generator().manual_seed(0))
    loss = dist.stage_loss(student, build_ldm(cfg, device="cpu", seed=0),
                           grid, 2, 1.0, torch.tensor(content),
                           torch.tensor(style),
                           torch.full((8,), 47, dtype=torch.long), noise)
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all()
               for p in student.unet.parameters())


# ---------------- the port's cascade ---------------------------------------


@pytest.fixture(scope="module")
def cascade(tmp_path_factory):
    """tests/test_distill.py's cascade: stages (4, 2), 24 steps each, lr
    1e-3, on the tiny config."""
    out = tmp_path_factory.mktemp("cascade")
    cfg = tiny(default_config())
    teacher = build_ldm(cfg, device="cpu", seed=0)
    before = _state(teacher)
    student, info = ProgressiveDistiller(cfg, t_max=100, device="cpu").distill(
        teacher, _batches(), stages=(4, 2), steps_per_stage=24, lr=1e-3,
        out_dir=out, seed=0)
    return cfg, before, teacher, student, info, out


def test_cascade_loss_falls(cascade):
    _, _, _, _, info, _ = cascade
    assert info["steps"] == 1 and info["stages"] == [4, 2]
    assert info["t_max"] == 100 and info["guidance"] == 1.0
    for st in info["history"]:
        assert np.isfinite(st["loss_head"]) and np.isfinite(st["loss_tail"])
    assert info["history"][0]["loss_tail"] < info["history"][0]["loss_head"]


def test_cascade_keeps_frozen_parts_and_moves_the_unet(cascade):
    _, before, teacher, student, _, _ = cascade
    after = _state(student)
    for comp in FROZEN:
        assert _same(before, after, comp + ".")
    assert not _same(before, after, "unet.")
    # the caller's teacher is left as it was
    assert all(torch.equal(v, before[k])
               for k, v in teacher.state_dict().items())


def test_cascade_checkpoints_load_with_their_metadata(cascade):
    cfg, before, _, student, _, out = cascade
    rows = (out / "distill_metrics.csv").read_text().splitlines()
    assert rows[0].split(",") == ["epoch", "teacher_steps", "student_steps",
                                  "steps", "loss_head", "loss_tail",
                                  "seconds"]
    assert len(rows) == 3
    for n, stages in ((2, [4]), (1, [4, 2])):
        path = out / f"distilled_{n}.pt"
        meta = checkpoint_distill_meta(path)
        assert meta == {"steps": n, "t_max": 100, "stages": stages,
                        "guidance": 1.0}
        model = load_ldm(cfg, full_checkpoint=str(path), dtype=torch.float32,
                         device="cpu")
        loaded = _state(model)
        for comp in FROZEN:
            assert _same(before, loaded, comp + ".")
    assert all(torch.equal(v, _state(student)[k]) for k, v in loaded.items())
    assert not list(out.glob("inflight_*"))


def test_student_transfers_on_its_grid(cascade):
    """The 1-step student samples through the stock transfer path at
    steps=2 (its grid linspace(99, 0, 2))."""
    cfg, _, _, student, _, out = cascade
    model = load_ldm(cfg, full_checkpoint=str(out / "distilled_1.pt"),
                     dtype=torch.float32, device="cpu")
    rng = np.random.RandomState(2)
    c = torch.tensor(rng.rand(2, 64, 64, 1).astype(np.float32))
    s = torch.tensor(rng.rand(2, 64, 64, 1).astype(np.float32))
    out_img, _ = content_style_transfer(model, c, s, num_timesteps=100,
                                        steps=2, seeds=[0, 1])
    assert out_img.shape == (2, 64, 64, 1)
    assert torch.isfinite(out_img).all()


def test_one_step_collapse(tmp_path):
    cfg = tiny(default_config())
    _, info = ProgressiveDistiller(cfg, device="cpu").distill(
        build_ldm(cfg, device="cpu"), _batches(1, batch=2),
        stages=(48, 24, 12, 6, 3),
        steps_per_stage=1, out_dir=tmp_path, inflight_every=0)
    assert info["steps"] == 1 and len(info["history"]) == 5
    assert info["history"][-1]["student_steps"] == 1
    assert checkpoint_distill_meta(tmp_path / "distilled_1.pt") == {
        "steps": 1, "t_max": 100, "stages": [48, 24, 12, 6, 3],
        "guidance": 1.0}


def test_guided_teacher_runs_in_the_first_stage_only(tmp_path, monkeypatch):
    cfg = tiny(default_config())
    dist = ProgressiveDistiller(cfg, device="cpu")
    seen = []
    real = dist.stage_loss

    def spy(student, teacher, grid, factor, guidance, *rest):
        seen.append((len(grid) - 1, factor, guidance))
        return real(student, teacher, grid, factor, guidance, *rest)

    monkeypatch.setattr(dist, "stage_loss", spy)
    _, info = dist.distill(build_ldm(cfg, device="cpu"), _batches(1, batch=2),
                           stages=(6, 3), steps_per_stage=2, guidance=2.0,
                           out_dir=tmp_path)
    assert seen == [(6, 2, 2.0)] * 2 + [(3, 3, 1.0)] * 2
    assert checkpoint_distill_meta(tmp_path / "distilled_1.pt") == {
        "steps": 1, "t_max": 100, "stages": [6, 3], "guidance": 2.0}


def test_exhausted_iterator_raises(tmp_path):
    cfg = tiny(default_config())
    with pytest.raises(RuntimeError, match="yielded no batches in a full "
                       "pass .* re-iterable loader"):
        ProgressiveDistiller(cfg, device="cpu").distill(
            build_ldm(cfg, device="cpu"), iter(_batches(1)), stages=(2,),
            steps_per_stage=3, out_dir=tmp_path)


def test_draws_come_from_seed_stage_and_step():
    cfg = tiny(default_config())
    a, b = (ProgressiveDistiller(cfg, device="cpu") for _ in range(2))
    for args in ((0, 1, 2), (3, 0, 7)):
        sa, na = a.draws(*args, 8, 4, (8, 8, 32))
        a.draws(5, 5, 5, 8, 4, (8, 8, 32))
        sb, nb = b.draws(*args, 8, 4, (8, 8, 32))
        assert torch.equal(sa, sb) and torch.equal(na, nb)
        assert sa.min() >= 0 and sa.max() < 4
    s1, n1 = a.draws(0, 1, 2, 8, 4, (8, 8, 32))
    s2, n2 = a.draws(0, 1, 3, 8, 4, (8, 8, 32))
    assert not torch.equal(n1, n2)


# ---------------- in-flight saves --------------------------------------------


class _Stop(Exception):
    pass


class _StopAfter:
    """A re-iterable loader that raises on its n-th batch overall."""

    def __init__(self, batches, n):
        self.batches, self.n, self.count = batches, n, 0

    def __iter__(self):
        for b in self.batches:
            self.count += 1
            if self.count == self.n:
                raise _Stop
            yield b


def _run(out, loader, cfg=None):
    cfg = cfg or tiny(default_config())
    return ProgressiveDistiller(cfg, device="cpu").distill(
        build_ldm(cfg, device="cpu", seed=0), loader, stages=(4, 2),
        steps_per_stage=4, lr=1e-3, out_dir=out, inflight_every=2)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    student, _ = _run(tmp_path_factory.mktemp("whole"), _batches(batch=2))
    return _state(student)


def test_interrupted_stage_resumes_where_it_stopped(tmp_path, capsys,
                                                   uninterrupted):
    """Stage 2 saves at step 2 and stops at its third batch; the rerun
    resumes it at step 2 with the saved Adam state and BatchNorm
    statistics, draws what the uninterrupted run drew, and lands on the
    same student bit for bit."""
    with pytest.raises(_Stop):
        _run(tmp_path, _StopAfter(_batches(batch=2), 7))
    saved = tmp_path / "inflight_2to1.pt"
    assert saved.exists() and not (tmp_path / "inflight_4to2.pt").exists()
    payload = torch.load(saved, weights_only=True)
    assert payload["extra"]["done"] == payload["step"] == 2
    assert payload["opt_state"]["state"]
    capsys.readouterr()
    student, _ = _run(tmp_path, _batches(batch=2))
    assert "distill 2->1: resumed in-flight at step 2/4" in \
        capsys.readouterr().out
    got = _state(student)
    assert all(torch.equal(got[k], v) for k, v in uninterrupted.items())
    assert not saved.exists()


def test_stale_inflight_save_restarts_the_stage(tmp_path, capsys,
                                                uninterrupted):
    """A save from another recipe (8 -> 4 under the 2 -> 1 name) is
    ignored: the stage starts over."""
    bad = build_ldm(tiny(default_config()), device="cpu", seed=5)
    opt = torch.optim.Adam(bad.unet.parameters())
    from music_style_transfer_ldm_tpu_torch.training import distill
    distill._save_inflight(tmp_path / "inflight_2to1.pt", bad, opt, {
        "done": 2, "teacher_steps": 8, "student_steps": 4, "head": 0.0})
    student, _ = _run(tmp_path, _batches(batch=2))
    assert "resumed" not in capsys.readouterr().out
    got = _state(student)
    assert all(torch.equal(got[k], v) for k, v in uninterrupted.items())


def test_corrupt_inflight_save_restarts_the_stage(tmp_path, capsys,
                                                  uninterrupted):
    (tmp_path / "inflight_2to1.pt").write_bytes(b"\x00 not a checkpoint")
    student, _ = _run(tmp_path, _batches(batch=2))
    assert "in-flight restore failed" in capsys.readouterr().out
    got = _state(student)
    assert all(torch.equal(got[k], v) for k, v in uninterrupted.items())
    assert not (tmp_path / "inflight_2to1.pt").exists()


# ---------------- cli distill ----------------------------------------------


def _actions(parser, command):
    sub = parser._subparsers._group_actions[0].choices[command]
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.required)
            for a in sub._actions if a.dest != "help"}


def test_distill_parser_is_jax_s_plus_device():
    got = _actions(cli.build_parser(), "distill")
    want = _actions(jax_cli.build_parser(), "distill")
    assert got.pop("device") == (("--device",), "cuda", None, False)
    assert got == want


def test_cli_distill_on_the_cpu(tmp_path, capsys):
    """Full width, B=2, two stages of two steps: checkpoints and the
    closing line."""
    rng = np.random.RandomState(4)
    imgs = tmp_path / "images"
    for label in ("a", "b"):
        (imgs / label).mkdir(parents=True)
        for i in range(2):
            (imgs / label / f"{i}.png").write_bytes(write_png_gray(
                rng.randint(0, 256, (128, 128)).astype(np.uint8)))
    cli.main(["generate-pairings", "--root", str(imgs), "--output",
              str(tmp_path / "pairs.csv"), "--num-pairs", "4"])
    ckpt = tmp_path / "teacher.pt"
    save_checkpoint(ckpt, build_ldm(device="cpu"))
    out = tmp_path / "distill"
    assert cli.main(["distill", "--checkpoint", str(ckpt), "--data-root",
                     str(imgs), "--pairing-file", str(tmp_path / "pairs.csv"),
                     "--out-dir", str(out), "--stages", "4,2",
                     "--steps-per-stage", "2", "--batch-size", "2",
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert (f"distilled to 1 steps; transfer with --steps 100 --sample-steps "
            f"2 (grids: [4, 2] -> 1); checkpoints under {out}") in printed
    assert sorted(os.listdir(out)) == ["distill_metrics.csv",
                                       "distilled_1.pt", "distilled_2.pt"]
    assert checkpoint_distill_meta(out / "distilled_2.pt")["stages"] == [4]

