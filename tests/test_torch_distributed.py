"""The port's data-parallel steps across spawned processes (CPU, gloo).

Each run starts 2 or 3 rank processes of ``_WORKER`` over a file store
under ``tmp_path`` (no fixed port, so xdist workers do not collide), one
torch thread each, at the tiny config.  The ranks split one global batch
of 6 rows, 4 real and 2 pad rows (2 ranks: the second holds one real
row; 3 ranks: the third holds none), and take one step each of the LDM
trainer (two variants), the AE trainer and the distiller.  They are held
to the JAX package's weighted global step on the whole batch, with the
draws injected (the two RNGs cannot agree), and to the port's
one-process step on the same batch.  The trainers' loop (resume, writes)
and ``cli train`` under ``torch.distributed.run`` are in
``test_torch_distributed_loop.py``.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.parallel import make_mesh as jax_make_mesh
from music_style_transfer_ldm_tpu.training import AETrainer as JaxAETrainer
from music_style_transfer_ldm_tpu.training import LDMTrainer as JaxTrainer
from music_style_transfer_ldm_tpu.training import distill as jax_distill
from music_style_transfer_ldm_tpu.training.state import (
    TrainState as JaxTrainState,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs, export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.layers import BatchNorm
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm
from music_style_transfer_ldm_tpu_torch.training import (
    AETrainer, LDMTrainer, ProgressiveDistiller,
)

ROOT = Path(__file__).resolve().parents[1]
RTOL_LOSS = 1e-5       # losses, f32 both sides
# The JAX package's f32 VGGish distance is 4.3e-5 (relative) from its
# float64-statistics value on these inputs, the port's 6.5e-8: the losses
# holding the VGGish term (style, total) are held to the port's float64
# oracle at RTOL_LOSS and to JAX at this bound.
RTOL_JAX_VGGISH = 1e-4
GRAD_OF_MAX = 1e-4     # per parameter: max abs error / its max |grad|
GRAD_STYLE = 1e-3      # the same against JAX with the style gradient on
RTOL_STATS = 1e-5      # BatchNorm running statistics
ATOL_STATS = 1e-6
ZERO_FLOOR = 1e-5      # of the largest gradient: the true gradient is 0
                       # (a conv bias feeding a train-mode BatchNorm)
ROWS, REAL = 6, 4      # the global batch: 4 real rows, then 2 pad rows
WEIGHTS = np.asarray([1.0] * REAL + [0.0] * (ROWS - REAL), np.float32)
VARIANTS = {"defaults": {},
            "style-grad": {"style_loss_stop_gradient": False}}
STAGE = (4, 2)         # the distill stage: 4 teacher steps into 2
METRICS = ("total_loss", "compression_loss", "denoising_loss", "style_loss")

_WORKER = r'''
"""One rank: python worker.py RANK WORLD STORE SPEC OUT."""
import dataclasses
import sys

import torch

torch.set_num_threads(1)

from music_style_transfer_ldm_tpu_torch import parallel
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.parallel import shard_batch
from music_style_transfer_ldm_tpu_torch.training import (
    AETrainer, LDMTrainer, ProgressiveDistiller,
)


def tiny(**train):
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32", **train)
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


def stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k}


def grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters()
            if p.grad is not None}


def main():
    rank, world, store, spec_path, out = sys.argv[1:6]
    assert parallel.initialize(store, int(world), int(rank), device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    mesh = parallel.make_mesh()
    res = {"mesh": mesh.shape, "info": parallel.process_info()}

    def rows(*keys):
        return shard_batch(tuple(torch.as_tensor(spec[k]) for k in keys),
                           mesh)
    (w,) = rows("weights")
    res["weights"] = w
    for name, train in spec["variants"].items():
        tr = LDMTrainer(tiny(**train), device="cpu")
        st = tr.init_state(0)
        st.model.load_state_dict(spec["ldm"])
        c, s, t, noise = rows("content", "style", "t", "noise")
        st, m = tr._step(st, c, s, t=t.long(), noise=noise, weights=w)
        res["ldm_" + name] = {"metrics": {k: v.item() for k, v in m.items()},
                              "grads": grads(st.model),
                              "stats": stats(st.model.decoder)}
    # the trainer's own draws (style dropout on): the global batch's rows
    tr = LDMTrainer(tiny(style_dropout=0.5), perceptual=False, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(spec["ldm"])
    c, s = rows("content", "style")
    draws = tr.draws(0, c.shape[0])
    st, m = tr._step(st, c, s, weights=w)
    res["ldm_own_draws"] = {"metrics": {k: v.item() for k, v in m.items()},
                            "grads": grads(st.model), "draws": draws,
                            "stats": stats(st.model.decoder)}
    ae = AETrainer(tiny(), perceptual=False, device="cpu")
    st = ae.init_state(0)
    st.model.load_state_dict(spec["ae"])
    (x,) = rows("ae_x")
    val = ae._eval(st, x, weights=w).item()
    st, loss = ae._step(st, x, weights=w)
    res["ae"] = {"val": val, "loss": loss.item(), "grads": grads(st.model),
                 "stats": stats(st.model)}
    dist = ProgressiveDistiller(tiny(), t_max=100, device="cpu")
    student = build_ldm(tiny(), device="cpu", seed=0)
    student.load_state_dict(spec["ldm"])
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, *spec["stage"], 1e-3)
    c, s, seg, noise = rows("content", "style", "segment", "d_noise")
    dist.draws = lambda *a: (seg.long(), noise)
    loss = dist.step(student, stage, c, s, 0, 0, weights=w)
    res["distill"] = {"loss": loss.item(), "grads": grads(student.unet)}
    torch.save(res, f"{out}.{rank}")
    parallel.shutdown()


main()
'''


def tiny(cfg, **train):
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32", **train)
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


def spawn(tmp_path: Path, worker: str, world: int, spec, args=(),
          timeout: float = 240) -> list:
    """``world`` ranks of ``worker`` over a file store; their results."""
    script = tmp_path / "worker.py"
    script.write_text(worker)
    spec_path = tmp_path / "spec.pt"
    torch.save(spec, spec_path)
    store, out = f"file://{tmp_path / 'store'}", tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), store,
         str(spec_path), str(out), *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(world)]


def _randomise_stats(module, rng):
    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, BatchNorm):
                n = mod.num_features
                mod.running_mean.copy_(torch.tensor(0.1 * rng.randn(n)))
                mod.running_var.copy_(torch.tensor(0.5 + rng.rand(n)))


def _grads_close(got, want, tol):
    """Per parameter: max abs error <= tol x that parameter's max |grad|
    (a parameter whose true gradient is 0: within ZERO_FLOOR of the
    largest); the number of parameters held."""
    top = max(float(np.abs(w).max()) for w in want.values())
    n = 0
    for name, w in want.items():
        g = got[name].numpy()
        scale = float(np.abs(w).max())
        if scale < ZERO_FLOOR * top:
            assert float(np.abs(g).max()) < ZERO_FLOOR * top, name
            continue
        err = float(np.abs(g - w).max()) / scale
        assert err < tol, (name, err)
        n += 1
    return n


def _stats_close(got, want):
    for k, t in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(t),
                                   rtol=RTOL_STATS, atol=ATOL_STATS,
                                   err_msg=k)


def _as_port(cfg, params, stats, part=None):
    """Flax-layout trees -> the port's names (``holder``'s modules)."""
    holder = build_ldm(cfg, device="cpu", seed=1)
    load_flax_variables(holder, {"params": params, "batch_stats": stats})
    module = holder if part is None else getattr(holder, part)
    return ({k: p.detach().numpy() for k, p in module.named_parameters()},
            {k: v.numpy() for k, v in module.state_dict().items()
             if "running" in k})


def _jax_ldm(cfg, ldm, c, s, t):
    """Per variant: the JAX LDM trainer's weighted _losses, gradients and
    decoder statistics on the global batch, and its q-sample noise."""
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       export_flax_variables(ldm))
    w = jnp.asarray(WEIGHTS)
    drng = jax.random.PRNGKey(5)
    out = {}
    for name, train in VARIANTS.items():
        jtr = JaxTrainer(tiny(jax_config(), **train), perceptual=True)
        port = LDMTrainer(tiny(default_config(), **train), device="cpu")
        fparams = (export_flax_convs(port.compression_feature.module),
                   export_flax_convs(port.style_feature.module))
        (_, (metrics, new_stats)), jgrads = jax.value_and_grad(
            lambda p, jtr=jtr, fp=fparams: jtr._losses(
                p, variables["batch_stats"], c, s, t, drng, fp, w),
            has_aux=True)(variables["params"])
        grads, _ = _as_port(cfg, jgrads, variables["batch_stats"])
        _, stats = _as_port(cfg, variables["params"], new_stats, "decoder")
        out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "grads": {k: v for k, v in grads.items()
                               if not k.startswith("encoder.")},
                     "stats": stats}
    out["noise"] = np.asarray(jtr.model.apply(
        variables, c, s, t, train=True, frozen_encoder=True,
        sample_weights=w, rngs={"diffusion": drng},
        mutable=["batch_stats"])[0]["noise"])
    return out


def _jax_ae(cfg, ae, x):
    """The JAX AETrainer's validation loss, then its step, on the global
    batch with its weights."""
    holder = build_ldm(cfg, device="cpu", seed=1)
    for comp in ("encoder", "decoder"):
        getattr(holder, comp).load_state_dict(getattr(ae, comp)
                                              .state_dict())
    v = jax.tree_util.tree_map(np.array, export_flax_variables(holder))
    variables = {kind: {c: v[kind][c] for c in ("encoder", "decoder")}
                 for kind in ("params", "batch_stats")}
    jtr = JaxAETrainer(tiny(jax_config()),
                       mesh=jax_make_mesh((2, 1), devices=jax.devices()[:2]),
                       perceptual=False)
    jstate = jtr.init_state(0).replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtr.tx.init(variables["params"]))
    w = jnp.asarray(WEIGHTS)
    val = float(jtr._val_step(jstate, x, None, w))
    jstate, loss = jtr._train_step(jstate, x, None, w)
    after = AETrainer(tiny(default_config()), perceptual=False,
                      device="cpu").init_state(0).model
    load_flax_variables(after, {"params": variables["params"],
                                "batch_stats": jstate.batch_stats})
    return {"val": val, "loss": float(loss),
            "stats": {k: t.numpy() for k, t in after.state_dict().items()
                      if "running" in k}}


def _capture_grads(*args, **kwargs):
    """An optax transformation whose state after a step is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _jax_distill(cfg, ldm, c, s):
    """The JAX distill step with the validity weights on the global
    batch: its loss, the UNet's gradient and its draws."""
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       export_flax_variables(ldm))
    jd = jax_distill.ProgressiveDistiller(
        tiny(jax_config()), mesh=jax_make_mesh((-1, 1)), t_max=100)
    grid, _ = jax_distill.distill_stage_grids(100, STAGE[0], 2)
    real = jax_distill.make_optimizer
    jax_distill.make_optimizer = _capture_grads
    try:
        step, tx = jd._stage_step_fn(grid, 1e-3, 2)
    finally:
        jax_distill.make_optimizer = real
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = JaxTrainState(params=params, batch_stats=jax.tree_util.tree_map(
        jnp.array, variables["batch_stats"]), opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32))
    key = jax.random.PRNGKey(3)
    new_state, metrics = step(state, variables["params"], jnp.asarray(c),
                              jnp.asarray(s), key, jnp.asarray(WEIGHTS))
    ikey, nkey = jax.random.split(key)
    grads, _ = _as_port(cfg, jax.tree_util.tree_map(
        np.asarray, new_state.opt_state), variables["batch_stats"], "unet")
    return {"loss": float(metrics["distill_loss"]), "grads": grads,
            "segment": np.asarray(jax.random.randint(ikey, (ROWS,), 0,
                                                     STAGE[1])),
            "noise": np.asarray(jax.random.normal(nkey, (ROWS, 8, 8, 32),
                                                  jnp.float32))}


def _port_ldm(ldm, c, s, t, noise, variant, stat_dtype=torch.float32):
    """The port's one-process step on the global batch with its weights
    (with ``stat_dtype`` float64: the VGGish statistics' oracle)."""
    saved = nm.STAT_DTYPE
    nm.STAT_DTYPE = stat_dtype
    try:
        tr = LDMTrainer(tiny(default_config(), **VARIANTS[variant]),
                        device="cpu")
        st = tr.init_state(0)
        st.model.load_state_dict(ldm.state_dict())
        st, m = tr._step(st, torch.tensor(c), torch.tensor(s),
                         t=torch.tensor(t).long(), noise=torch.tensor(noise),
                         weights=torch.tensor(WEIGHTS))
    finally:
        nm.STAT_DTYPE = saved
    return {"metrics": {k: v.item() for k, v in m.items()},
            "grads": {k: p.grad.numpy() for k, p in
                      st.model.named_parameters() if p.grad is not None}}


def _port_distill(ldm, c, s, segment, noise):
    """The port's one-process distill step on the global batch with its
    weights and the draws injected."""
    dist = ProgressiveDistiller(tiny(default_config()), t_max=100,
                                device="cpu")
    student = build_ldm(tiny(default_config()), device="cpu", seed=0)
    student.load_state_dict(ldm.state_dict())
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, *STAGE, 1e-3)
    dist.draws = lambda *a: (torch.tensor(segment).long(),
                             torch.tensor(noise))
    loss = dist.step(student, stage, torch.tensor(c), torch.tensor(s), 0, 0,
                     weights=torch.tensor(WEIGHTS))
    return {"loss": loss.item(),
            "grads": {k: p.grad.numpy() for k, p in
                      student.unet.named_parameters() if p.grad is not None}}


@pytest.fixture(scope="module")
def reference():
    """The weights, the global batch and every reference of both runs."""
    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    cfg = tiny(default_config())
    ldm = build_ldm(cfg, device="cpu", seed=0)
    _randomise_stats(ldm, rng)
    ae = AETrainer(cfg, perceptual=False, device="cpu").init_state(0).model
    _randomise_stats(ae, rng)
    c, s, x = (rng.rand(ROWS, 64, 64, 1).astype(np.float32)
               for _ in range(3))
    t = rng.randint(0, 200, ROWS).astype(np.int32)
    jldm = _jax_ldm(cfg, ldm, c, s, t)
    jdist = _jax_distill(cfg, ldm, c, s)
    port = {v: _port_ldm(ldm, c, s, t, jldm["noise"], v) for v in VARIANTS}
    oracle = {v: _port_ldm(ldm, c, s, t, jldm["noise"], v, torch.float64)
              for v in VARIANTS}
    # the one-process step with the trainer's own draws
    tr = LDMTrainer(tiny(default_config(), style_dropout=0.5),
                    perceptual=False, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(ldm.state_dict())
    draws = tr.draws(0, ROWS)
    st, m = tr._step(st, torch.tensor(c), torch.tensor(s),
                     weights=torch.tensor(WEIGHTS))
    own = {"metrics": {k: v.item() for k, v in m.items()}, "draws": draws,
           "grads": {k: p.grad.numpy() for k, p in
                     st.model.named_parameters() if p.grad is not None},
           "stats": {k: v.numpy() for k, v in
                     st.model.decoder.state_dict().items() if "running" in k}}
    spec = {"variants": VARIANTS, "ldm": ldm.state_dict(),
            "ae": ae.state_dict(), "content": c, "style": s, "t": t,
            "noise": jldm["noise"], "ae_x": x, "weights": WEIGHTS,
            "segment": jdist["segment"], "d_noise": jdist["noise"],
            "stage": STAGE}
    return {"spec": spec, "jax": jldm, "ae": _jax_ae(cfg, ae, x),
            "distill": jdist, "port": port, "oracle": oracle, "own": own,
            "distill_one": _port_distill(ldm, c, s, jdist["segment"],
                                         jdist["noise"])}


@pytest.fixture(scope="module", params=[2, 3], ids=["2-ranks", "3-ranks"])
def run(request, reference, tmp_path_factory):
    world = request.param
    ranks = spawn(tmp_path_factory.mktemp(f"ranks{world}"), _WORKER, world,
                  reference["spec"])
    return world, ranks, reference


def test_ranks_see_one_mesh_and_one_weight_block_each(run):
    world, ranks, _ = run
    per = ROWS // world
    for r, res in enumerate(ranks):
        assert res["mesh"] == {"data": world, "model": 1}
        assert res["info"] == {"process_index": r, "process_count": world,
                               "local_devices": 1, "global_devices": world}
        np.testing.assert_array_equal(res["weights"].numpy(),
                                      WEIGHTS[r * per:(r + 1) * per])
    if world == 3:
        assert float(ranks[2]["weights"].sum()) == 0.0   # no real row


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ldm_losses_match_the_oracle_and_jax(run, variant):
    _, ranks, ref = run
    want, oracle = ref["jax"][variant]["metrics"], ref["oracle"][variant]
    for res in ranks:
        got = res["ldm_" + variant]["metrics"]
        for k in METRICS:
            np.testing.assert_allclose(got[k], oracle["metrics"][k],
                                       rtol=RTOL_LOSS, err_msg=k)
            tol = (RTOL_LOSS if k in ("compression_loss", "denoising_loss")
                   else RTOL_JAX_VGGISH)
            np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ldm_gradients_and_statistics_match_jax(run, variant):
    _, ranks, ref = run
    want = ref["jax"][variant]
    tol = GRAD_OF_MAX if variant == "defaults" else GRAD_STYLE
    for res in ranks:
        got = res["ldm_" + variant]
        assert not any(k.startswith("encoder.") for k in got["grads"])
        assert _grads_close(got["grads"], want["grads"], tol) > 20
        assert _grads_close(got["grads"], ref["port"][variant]["grads"],
                            GRAD_OF_MAX) > 20
        _stats_close(got["stats"], want["stats"])


def test_every_rank_holds_the_same_statistics_and_gradients(run):
    _, ranks, _ = run
    for res in ranks[1:]:
        for case in ("ldm_defaults", "ldm_style-grad", "ldm_own_draws",
                     "ae"):
            for part in ("stats", "grads"):
                for k, t in ranks[0][case][part].items():
                    assert torch.equal(res[case][part][k], t), (case, k)
        for k, t in ranks[0]["distill"]["grads"].items():
            assert torch.equal(res["distill"]["grads"][k], t), k


def test_the_ranks_step_equals_the_one_process_step(run):
    """The trainer's own draws are made for the whole global batch and
    each rank keeps its rows, so the N-rank step is the one-process step
    on that batch."""
    world, ranks, ref = run
    own = ref["own"]
    per = ROWS // world
    for r, res in enumerate(ranks):
        got = res["ldm_own_draws"]
        for a, b in zip(got["draws"], own["draws"]):
            assert torch.equal(a, b[r * per:(r + 1) * per])
        for k, v in own["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=RTOL_LOSS,
                                       err_msg=k)
        assert _grads_close(got["grads"], own["grads"], GRAD_OF_MAX) > 20
        _stats_close(got["stats"], own["stats"])


def test_ae_step_matches_the_jax_global_step(run):
    _, ranks, ref = run
    want = ref["ae"]
    for res in ranks:
        got = res["ae"]
        np.testing.assert_allclose(got["val"], want["val"], rtol=RTOL_LOSS)
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   rtol=RTOL_LOSS)
        _stats_close(got["stats"], want["stats"])


def test_distill_step_matches_the_jax_global_step(run):
    """The ranks' distill step (the UNet in DistributedDataParallel)
    against JAX's weighted global step and the port's one-process step."""
    _, ranks, ref = run
    for want in (ref["distill"], ref["distill_one"]):
        for res in ranks:
            got = res["distill"]
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=RTOL_LOSS)
            assert _grads_close(got["grads"], want["grads"],
                                GRAD_OF_MAX) > 20
