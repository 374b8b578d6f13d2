"""The port's tensor parallelism: a model axis over process groups (CPU).

The partition rule is held to the JAX package's ``param_partition_spec``
parameter by parameter on a JAX mesh over the 8 CPU devices.  The steps
run in spawned gloo ranks (``test_torch_distributed.spawn``: a file store
under tmp_path, one torch thread each) at the tiny config, on (1, 2),
(2, 2) and (2, 1) meshes in that order: the LDM trainer's step (LPIPS
compression, VGGish style), the AE trainer's and the distiller's, on a
global batch of 3 rows (padded to 4 at two data indices), each held to
the port's one-process step on those rows.  The (1, 2) run writes a
train-state checkpoint that one process loads bit for bit, and that the
(2, 2) and (2, 1) runs resume from.  The JAX package's own runs hold its
sharded steps to its replicated ones (``tests/test_parallel.py``); the
port's sequence parallelism is in ``test_torch_sequence_parallel.py``.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.parallel import make_mesh as jax_make_mesh
from music_style_transfer_ldm_tpu.parallel.sharding import (
    param_partition_spec,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.layers import BatchNorm
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.parallel import Mesh, make_mesh
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    param_partition, shard_params, split_dims, training_mesh,
)
from music_style_transfer_ldm_tpu_torch.training import (
    AETrainer, LDMTrainer, ProgressiveDistiller,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt
from test_torch_distributed import spawn

RTOL_LOSS = 1e-5       # losses, f32 both sides
GRAD_OF_MAX = 1e-4     # per parameter: max abs error / its max |grad|
# The AE step with the KL term on: its z / (z^2 + 1e-8) amplifies the
# rounding of the forward, so the encoder's gradients keep the bar the
# data-parallel AE step keeps, 3e-2 of max (PERF.md section 2); the
# decoder's, and the AE with neither term, at GRAD_OF_MAX.
AE_KL_OF_MAX = {"encoder.": 3e-2, "decoder.": GRAD_OF_MAX}
ZERO_FLOOR = 1e-5      # of the largest gradient: the true gradient is 0
RTOL_STATS, ATOL_STATS = 1e-5, 1e-6
ROWS = 3               # the global batch (padded to 4 at two data indices)
STAGE = (4, 2)         # the distill stage: 4 teacher steps into 2
MESHES = ((1, 2), (2, 2), (2, 1))
LDM_PARAMS, LDM_SPLIT = 9_881_537, 9_600_128
CPU = torch.device("cpu")

_WORKER = r'''
"""One rank: python worker.py RANK WORLD STORE SPEC OUT N M."""
import dataclasses
import sys

import torch

torch.set_num_threads(1)

from music_style_transfer_ldm_tpu_torch import parallel
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.parallel import shard_batch
from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    model_axis,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    gather_tensors, gathered_state_dict, local_blocks, rank_batch,
    shard_params, split_dims, sync_replicated,
)
from music_style_transfer_ldm_tpu_torch.training import (
    AETrainer, LDMTrainer, ProgressiveDistiller,
)
from music_style_transfer_ldm_tpu_torch.training import checkpoint as ckpt


def tiny(shape):
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    cfg.mesh = dataclasses.replace(cfg.mesh, mesh_shape=shape)
    return cfg


def load(module, state, mesh):
    module.load_state_dict(local_blocks(state, split_dims(module), mesh))


def whole_grads(module, mesh):
    grads = {k: p.grad for k, p in module.named_parameters()
             if p.grad is not None}
    return gather_tensors(grads, split_dims(module), mesh)


def stats(module, mesh):
    return {k: v for k, v in gathered_state_dict(module, mesh).items()
            if "running" in k}


def main():
    rank, world, store, spec_path, out, n, m = sys.argv[1:8]
    shape = (int(n), int(m))
    assert parallel.initialize(store, int(world), int(rank), device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    mesh = parallel.make_mesh(shape)
    res = {"mesh": (mesh.shape, mesh.data_index, mesh.model_index)}
    cfg = tiny(shape)
    (c, s, x), w = rank_batch(tuple(torch.as_tensor(spec[k]) for k in
                                    ("content", "style", "ae_x")), mesh)
    t, noise, seg, d_noise = shard_batch(tuple(
        torch.as_tensor(spec[k]) for k in ("t", "noise", "segment",
                                           "d_noise")), mesh)
    kw = {} if w is None else {"weights": w}

    tr = LDMTrainer(cfg, device="cpu")
    st = tr.init_state(0)
    load(st.model, spec["ldm"], mesh)
    st, met = tr._step(st, c, s, t=t.long(), noise=noise, **kw)
    res["ldm"] = {"metrics": {k: v.item() for k, v in met.items()},
                  "grads": whole_grads(st.model, mesh),
                  "stats": stats(st.model.decoder, mesh)}
    if shape == (1, 2):
        ckpt.save_train_state(spec["ckpt"], st, mesh=mesh)
        res["ldm"]["params"] = gathered_state_dict(st.model, mesh)
        res["roundtrip"] = parallel.gather_params(
            shard_params(build_ldm(cfg, device="cpu", seed=0), mesh),
            mesh).state_dict()
    else:
        # resume the (1, 2) run's checkpoint here and take its next step
        tr = LDMTrainer(cfg, perceptual=False, device="cpu")
        st = ckpt.restore_train_state(spec["ckpt"], tr.init_state(0), mesh)
        # copies: the step below changes the live tensors in place
        res["restored"] = {
            "params": {k: v.clone() for k, v in
                       gathered_state_dict(st.model, mesh).items()},
            "moments": {i: {k: v.clone() for k, v in m.items()} for i, m in
                        st.optimizer.state_dict()["state"].items()},
            "names": [k for k, p in st.model.named_parameters()
                      if p.requires_grad]}
        st, met = tr._step(st, c, s, t=t.long(), noise=noise, **kw)
        res["resumed"] = {"metrics": {k: v.item() for k, v in met.items()},
                          "grads": whole_grads(st.model, mesh)}

    for case, kl, perceptual in (("ae", 0.01, True), ("ae_plain", 0.0,
                                                      False)):
        ae = AETrainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, kl_weight=kl)), perceptual=perceptual, device="cpu")
        st = ae.init_state(0)
        load(st.model, spec["ae"], mesh)
        val = ae._eval(st, x, **kw).item()
        st, loss = ae._step(st, x, **kw)
        res[case] = {"val": val, "loss": loss.item(),
                     "grads": whole_grads(st.model, mesh),
                     "stats": stats(st.model, mesh)}

    dist = ProgressiveDistiller(cfg, t_max=100, device="cpu")
    student = build_ldm(cfg, device="cpu", seed=0)
    student.load_state_dict(spec["ldm"])
    shard_params(student, mesh)
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, *spec["stage"], 1e-3)
    res["teacher_whole"] = all(
        t.shape == spec["ldm"][k].shape
        for k, t in stage.teacher.state_dict().items())
    dist.draws = lambda *a: (seg.long(), d_noise)
    loss = dist.step(student, stage, c, s, 0, 0, **kw)
    res["distill"] = {"loss": loss.item(),
                      "grads": whole_grads(student.unet, mesh)}

    # replicated tensors that differ between the peers (as rounding makes
    # them on the card): sync_replicated gives each peer model index 0's
    rank = int(rank)
    probe = shard_params(build_ldm(cfg, device="cpu", seed=0), mesh)
    for p in probe.parameters():
        p.grad = torch.full_like(p, rank + 1.0)
    for b in probe.buffers():
        if b.is_floating_point():
            b.fill_(rank + 1.0)

    def values():
        tensors = {k: p.grad for k, p in probe.named_parameters()}
        tensors.update((k, b) for k, b in probe.named_buffers()
                       if b.is_floating_point())
        return {k: t.unique().tolist() for k, t in tensors.items()}
    sync_replicated(probe, model_axis(mesh, sequence=True))
    res["sync"] = {"sequence": values(), "split": split_dims(probe)}
    sync_replicated(probe, model_axis(mesh))
    res["sync"]["tensor"] = values()
    torch.save(res, f"{out}.{rank}")
    parallel.shutdown()


main()
'''


def tiny(cfg=None, **train):
    cfg = cfg or default_config()
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
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


def _grads(module):
    return {k: p.grad.clone() for k, p in module.named_parameters()
            if p.grad is not None}


def _grads_close(got, want, tol):
    """Per parameter: max abs error <= tol x its max |grad| (``tol`` a
    number, or {name prefix: bar}); a parameter whose true gradient is 0
    within ZERO_FLOOR of the largest.  Returns the number held."""
    top = max(float(w.abs().max()) for w in want.values())
    assert sorted(got) == sorted(want)
    n = 0
    for name, w in want.items():
        g, scale = got[name], float(w.abs().max())
        if scale < ZERO_FLOOR * top:
            assert float(g.abs().max()) < ZERO_FLOOR * top, name
            continue
        bar = (tol if not isinstance(tol, dict)
               else next(v for k, v in tol.items() if name.startswith(k)))
        err = float((g - w).abs().max()) / scale
        assert err < bar, (name, err)
        n += 1
    return n


def _close(got, want):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   rtol=RTOL_STATS, atol=ATOL_STATS,
                                   err_msg=k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process references and the three meshes' ranks, in order
    (the (1, 2) run writes the checkpoint the others resume)."""
    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    cfg = tiny()
    ldm = build_ldm(cfg, device="cpu", seed=0)
    _randomise_stats(ldm, rng)
    ae = AETrainer(cfg, device="cpu").init_state(0).model
    _randomise_stats(ae, rng)
    c, s, x = (rng.rand(ROWS, 64, 64, 1).astype(np.float32)
               for _ in range(3))
    t = rng.randint(0, 200, ROWS)
    noise = rng.randn(ROWS, 8, 8, 32).astype(np.float32)
    segment = rng.randint(0, STAGE[1], ROWS)
    d_noise = rng.randn(ROWS, 8, 8, 32).astype(np.float32)
    path = tmp_path_factory.mktemp("ckpt") / "tp.pt"
    spec = {"ldm": ldm.state_dict(), "ae": ae.state_dict(), "content": c,
            "style": s, "ae_x": x, "t": t, "noise": noise,
            "segment": segment, "d_noise": d_noise, "stage": STAGE,
            "ckpt": str(path)}
    T = torch.tensor

    one = {}
    tr = LDMTrainer(cfg, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(ldm.state_dict())
    st, met = tr._step(st, T(c), T(s), t=T(t).long(), noise=T(noise))
    one["ldm"] = {"metrics": {k: v.item() for k, v in met.items()},
                  "grads": _grads(st.model),
                  "stats": {k: v for k, v in
                            st.model.decoder.state_dict().items()
                            if "running" in k}}
    for case, kl, perceptual in (("ae", 0.01, True), ("ae_plain", 0.0,
                                                      False)):
        aet = AETrainer(tiny(kl_weight=kl), perceptual=perceptual,
                        device="cpu")
        st = aet.init_state(0)
        st.model.load_state_dict(ae.state_dict())
        val = aet._eval(st, T(x)).item()
        st, loss = aet._step(st, T(x))
        one[case] = {"val": val, "loss": loss.item(),
                     "grads": _grads(st.model),
                     "stats": {k: v for k, v in
                               st.model.state_dict().items()
                               if "running" in k}}
    dist = ProgressiveDistiller(cfg, t_max=100, device="cpu")
    student = build_ldm(cfg, device="cpu", seed=0)
    student.load_state_dict(ldm.state_dict())
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, *STAGE, 1e-3)
    dist.draws = lambda *a: (T(segment).long(), T(d_noise))
    loss = dist.step(student, stage, T(c), T(s), 0, 0)
    one["distill"] = {"loss": loss.item(), "grads": _grads(student.unet)}

    tmp = tmp_path_factory.mktemp("tp")
    ranks = {}
    for n, m in MESHES:
        d = tmp / f"{n}x{m}"
        d.mkdir()
        ranks[(n, m)] = spawn(d, _WORKER, n * m, spec, (str(n), str(m)))
        shutil.rmtree(d)       # the ranks' files are read: free the disk
        if (n, m) == (1, 2):
            # the resumed runs' reference: one process from the file
            tr = LDMTrainer(cfg, perceptual=False, device="cpu")
            st = ckpt.restore_train_state(path, tr.init_state(0))
            st, met = tr._step(st, T(c), T(s), t=T(t).long(),
                               noise=T(noise))
            one["resumed"] = {"metrics": {k: v.item()
                                          for k, v in met.items()},
                              "grads": _grads(st.model)}
    return {"one": one, "ranks": ranks, "ckpt": path, "spec": spec}


# ---------------- the mesh and the partition rule ---------------------------


def test_mesh_layout_matches_jax_and_one_process_refuses_a_model_axis(runs):
    jmesh = jax_make_mesh((2, 4))
    devices = jax.devices()
    for r in range(8):       # rank r: data index r // m, model index r % m
        mesh = Mesh({"data": 2, "model": 4}, (CPU,) * 8, group=object(),
                    index=r)
        assert jmesh.devices[mesh.data_index, mesh.model_index] == devices[r]
    for (n, m), ranks in runs["ranks"].items():
        assert [r["mesh"] for r in ranks] == [
            ({"data": n, "model": m}, r // m, r % m) for r in range(n * m)]
    with pytest.raises(ValueError, match="one process per rank"):
        make_mesh((2, 4), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="one process per rank"):
        make_mesh((1, 2), devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        make_mesh((3, 2), devices=["cpu"] * 8)      # 6 != 8
    cfg = default_config()
    cfg.mesh = dataclasses.replace(cfg.mesh, mesh_shape=(1, 2))
    with pytest.raises(ValueError, match="one process per rank"):
        training_mesh(cfg.mesh, device="cpu")


def test_partition_rule_on_wide_and_narrow_layers():
    wide, narrow = torch.nn.Conv2d(64, 128, 3), torch.nn.Conv2d(1, 64, 3)
    jmesh = jax_make_mesh((2, 4))
    assert param_partition(wide, 4) == {"weight": 0, "bias": 0}
    assert param_partition(narrow, 4) == {}
    assert param_partition_spec((), np.zeros((3, 3, 64, 128)),
                                jmesh)[-1] == "model"
    assert param_partition_spec((), np.zeros((3, 3, 1, 64)),
                                jmesh) == jax.sharding.PartitionSpec()
    # a transpose conv's output channels are its weight's dim 1; 130 does
    # not divide by 4
    assert param_partition(torch.nn.ConvTranspose2d(32, 128, 4), 2) == {
        "weight": 1, "bias": 0}
    assert param_partition(torch.nn.Linear(8, 130), 4) == {}
    assert param_partition(torch.nn.Linear(8, 130), 2) == {"weight": 0,
                                                            "bias": 0}


@pytest.mark.parametrize("m", [2, 4])
def test_partition_matches_jax_per_parameter(m):
    """Each rank's block of every parameter and BatchNorm statistic, in
    flax layout, is JAX's block of that leaf under param_partition_spec
    on a (8 / m, m) mesh; 9,600,128 of the LDM's 9,881,537 parameters
    split."""
    full = build_ldm(device="cpu", seed=0)
    want = export_flax_variables(full)
    jmesh = jax_make_mesh((8 // m, m))
    split = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        spec = param_partition_spec(path, leaf, jmesh)
        split[jax.tree_util.keystr(path)] = "model" in tuple(spec)
        if "model" in tuple(spec):
            assert tuple(spec) == (None,) * (leaf.ndim - 1) + ("model",)
    n_params = sum(int(np.prod(leaf.shape)) for path, leaf in
                   jax.tree_util.tree_leaves_with_path(want["params"]))
    n_split = sum(int(np.prod(leaf.shape)) for path, leaf in
                  jax.tree_util.tree_leaves_with_path(want["params"])
                  if split["['params']" + jax.tree_util.keystr(path)])
    assert (n_params, n_split) == (LDM_PARAMS, LDM_SPLIT)
    dims = param_partition(full, m)
    assert sum(p.numel() for k, p in full.named_parameters()
               if k in dims) == LDM_SPLIT
    for j in range(m):
        part = shard_params(build_ldm(device="cpu", seed=0),
                            Mesh({"data": 8 // m, "model": m}, (CPU,) * 8,
                                 index=j))
        assert split_dims(part) == dims
        got = export_flax_variables(part)
        for path, leaf in jax.tree_util.tree_leaves_with_path(want):
            key = jax.tree_util.keystr(path)
            block = (np.split(leaf, m, axis=-1)[j] if split[key] else leaf)
            mine = dict(jax.tree_util.tree_leaves_with_path(got))[path]
            np.testing.assert_array_equal(mine, block, err_msg=key)


# ---------------- the three trainers' steps ----------------------------------


@pytest.mark.parametrize("mesh", MESHES[:2], ids=["1x2", "2x2"])
def test_ldm_step_matches_one_process(runs, mesh):
    want = runs["one"]["ldm"]
    for res in runs["ranks"][mesh]:
        got = res["ldm"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= RTOL_LOSS * abs(v), k
        assert _grads_close(got["grads"], want["grads"], GRAD_OF_MAX) > 20
        _close(got["stats"], want["stats"])


@pytest.mark.parametrize("case", ["ae", "ae_plain"])
@pytest.mark.parametrize("mesh", MESHES[:2], ids=["1x2", "2x2"])
def test_ae_step_matches_one_process(runs, mesh, case):
    """The AE step, the defaults (KL and LPIPS: the encoder's gradients
    at 3e-2 of max) and with neither term (gradients at GRAD_OF_MAX)."""
    want = runs["one"][case]
    for res in runs["ranks"][mesh]:
        got = res[case]
        for k in ("val", "loss"):
            assert abs(got[k] - want[k]) <= RTOL_LOSS * abs(want[k]), k
        assert _grads_close(got["grads"], want["grads"],
                            AE_KL_OF_MAX if case == "ae" else GRAD_OF_MAX) > 8
        _close(got["stats"], want["stats"])


@pytest.mark.parametrize("mesh", MESHES[:2], ids=["1x2", "2x2"])
def test_distill_step_matches_one_process(runs, mesh):
    want = runs["one"]["distill"]
    for res in runs["ranks"][mesh]:
        assert res["teacher_whole"]
        got = res["distill"]
        assert abs(got["loss"] - want["loss"]) <= RTOL_LOSS * abs(
            want["loss"])
        assert _grads_close(got["grads"], want["grads"], GRAD_OF_MAX) > 20


# ---------------- parameters and checkpoints ---------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=["1x2", "2x2", "2x1"])
def test_sync_replicated_gives_peers_model_index_0s_copies(runs, mesh):
    """Each rank filled every gradient and floating buffer with rank + 1:
    under tensor parallelism the replicated ones become model index 0's
    (rank data_index x m + 1), the split blocks stay this rank's; under
    sequence parallelism and at a model axis of 1 nothing changes."""
    n, m = mesh
    for r, res in enumerate(runs["ranks"][mesh]):
        sync = res["sync"]
        assert all(v == [r + 1.0] for v in sync["sequence"].values())
        first = (r // m) * m + 1.0
        for k, v in sync["tensor"].items():
            assert v == [r + 1.0 if k in sync["split"] else first], k
        assert bool(sync["split"]) == (m > 1)


def test_gather_params_inverts_shard_params(runs):
    want = build_ldm(tiny(), device="cpu", seed=0).state_dict()
    for res in runs["ranks"][(1, 2)]:
        got = res["roundtrip"]
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], v) for k, v in want.items())


def test_checkpoint_of_1x2_loads_in_one_process_bit_for_bit(runs):
    payload = ckpt.load_checkpoint(runs["ckpt"])
    gathered = runs["ranks"][(1, 2)][0]["ldm"]["params"]
    assert sorted(payload["params"]) == sorted(gathered)
    assert all(torch.equal(payload["params"][k], v.float())
               for k, v in gathered.items())
    model = build_ldm(tiny(), device="cpu", seed=1)
    model.load_state_dict(payload["params"])            # whole tensors
    # Adam's moments are whole too: one per trainable parameter, shaped
    # like it
    names = [k for k, p in model.named_parameters()
             if not k.startswith("encoder.")]
    moments = payload["opt_state"]["state"]
    assert len(moments) == len(names)
    shapes = dict((k, p.shape) for k, p in model.named_parameters())
    for i, name in enumerate(names):
        assert moments[i]["exp_avg"].shape == shapes[name], name


@pytest.mark.parametrize("mesh", MESHES[1:], ids=["2x2", "2x1"])
def test_checkpoint_of_1x2_resumes_on_another_mesh(runs, mesh):
    payload = ckpt.load_checkpoint(runs["ckpt"])
    want = runs["one"]["resumed"]
    m = mesh[1]
    dims = param_partition(build_ldm(tiny(), device="cpu"), m)
    for r, res in enumerate(runs["ranks"][mesh]):
        got = res["restored"]
        assert all(torch.equal(got["params"][k], v.float())
                   for k, v in payload["params"].items())
        # this rank's blocks of Adam's moments
        for i, name in enumerate(got["names"]):
            whole = payload["opt_state"]["state"][i]["exp_avg"]
            dim = dims.get(name)
            block = whole if dim is None else whole.chunk(m, dim)[r % m]
            assert torch.equal(got["moments"][i]["exp_avg"], block), name
        for k, v in want["metrics"].items():
            assert abs(res["resumed"]["metrics"][k] - v) <= RTOL_LOSS * abs(
                v), k
        assert _grads_close(res["resumed"]["grads"], want["grads"],
                            GRAD_OF_MAX) > 20
