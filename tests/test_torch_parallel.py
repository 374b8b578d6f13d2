"""The port's data parallelism in one process, against the JAX package.

The mesh, the pad-row weights and their per-rank blocks, the masked
BatchNorm, the autoencoder's padded tail batch and the meshed serving
engine are held to the JAX package on the CPU (JAX runs on its 8 virtual
CPU devices).  A rank's view of a process group is a ``Mesh`` with a
group and an index: the functions here read no collective from it.  The
runs across spawned processes are in ``test_torch_distributed.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from hypothesis import given, settings
from hypothesis import strategies as st

from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.datasets.packed import (
    write_pack as jax_write_pack,
)
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.parallel import make_mesh as jax_make_mesh
from music_style_transfer_ldm_tpu.parallel import shard_batch as jax_shard
from music_style_transfer_ldm_tpu.parallel.sharding import (
    batch_validity_weights as jax_weights,
)
from music_style_transfer_ldm_tpu.parallel.sharding import (
    pad_batch_to_multiple as jax_pad,
)
from music_style_transfer_ldm_tpu.serving.engine import (
    EngineConfig as JaxEngineConfig,
)
from music_style_transfer_ldm_tpu.serving.engine import (
    InferenceEngine as JaxEngine,
)
from music_style_transfer_ldm_tpu.training import AETrainer as JaxAETrainer
from music_style_transfer_ldm_tpu_torch import cli
from music_style_transfer_ldm_tpu_torch import parallel
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.datasets import (
    DevicePairLoader, DeviceResidentPairs,
)
from music_style_transfer_ldm_tpu_torch.datasets.loader import (
    EpochBatches, process_local_indices,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.layers import BatchNorm
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.parallel import (
    Mesh, batch_validity_weights, make_mesh, pad_batch_to_multiple,
    shard_batch,
)
from music_style_transfer_ldm_tpu_torch.parallel.distributed import (
    process_device,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    global_batch_from_local, loader_global_rows, rank_batch, step_rows,
    training_mesh,
)
from music_style_transfer_ldm_tpu_torch.serving import engine as engine_mod
from music_style_transfer_ldm_tpu_torch.serving.engine import (
    EngineConfig, InferenceEngine,
)
from music_style_transfer_ldm_tpu_torch.training import AETrainer, LDMTrainer

RTOL = 1e-5            # losses and statistics, f32 both sides
STATS_ATOL = 1e-6      # running statistics near 0
TRANSFER_ATOL = 1e-4   # decoded images in [0, 1], f32, 11 steps
CPU = torch.device("cpu")
AE = ("encoder", "decoder")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tiny(cfg):
    """tests/test_padding_mask.py's config: 64x64, B=4, f32."""
    cfg.train = dataclasses.replace(cfg.train, batch_size=4, num_epochs=1,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    return cfg


def rank_mesh(rank: int, world: int) -> Mesh:
    """Rank ``rank``'s view of a ``world``-rank process group on the CPU
    (the group is a stand-in: nothing here runs a collective)."""
    return Mesh({"data": world, "model": 1}, (CPU,) * world,
                group=object(), index=rank)


# ---------------- mesh, process group ----------------------------------------


def test_make_mesh_shapes_and_errors():
    m = make_mesh((-1, 1), devices=["cpu"] * 8)
    assert m.shape == {"data": 8, "model": 1} and m.size == 8
    assert not m.distributed and m.device == CPU and m.index == 0
    assert make_mesh((4, 1), devices=["cpu"] * 4).shape["data"] == 4
    with pytest.raises(ValueError):
        make_mesh((3, 2), devices=["cpu"] * 8)      # 6 != 8
    with pytest.raises(ValueError):
        make_mesh((-1, 3), devices=["cpu"] * 8)     # 8 not divisible by 3
    with pytest.raises(ValueError):
        jax_make_mesh((3, 2))                       # the JAX package agrees
    with pytest.raises(ValueError, match="one process per rank"):
        make_mesh((2, 4), devices=["cpu"] * 8)      # JAX: dp 2 x tp 4
    assert jax_make_mesh((2, 4)).shape["model"] == 4
    # a model axis is ranks: (2, 4) over 8 ranks, this one rank 6
    rank6 = Mesh({"data": 2, "model": 4}, (CPU,) * 8, group=object(),
                 index=6)
    assert (rank6.data_index, rank6.model_index, rank6.size) == (1, 2, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()                             # no silent CPU mesh
    cfg = default_config()
    cfg.mesh = dataclasses.replace(cfg.mesh, sequence_parallel=True)
    # sequence parallelism is taken (a no-op at a model axis of 1)
    assert training_mesh(cfg.mesh, device="cpu").shape == {"data": 1,
                                                           "model": 1}
    with pytest.raises(ValueError, match="one process per card"):
        training_mesh(default_config().mesh,
                      make_mesh((2, 1), devices=["cpu", "cpu"]))


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize() is False
    assert not torch.distributed.is_initialized()
    info = parallel.process_info()
    assert sorted(info) == ["global_devices", "local_devices",
                            "process_count", "process_index"]
    assert info["process_index"] == 0 and info["process_count"] == 1
    parallel.shutdown()                              # nothing to destroy
    with pytest.raises(ValueError, match="together"):
        parallel.initialize("localhost:1234")
    if not torch.cuda.is_available():
        # a torchrun rank with no card raises instead of taking the CPU
        monkeypatch.setenv("RANK", "0")
        monkeypatch.setenv("WORLD_SIZE", "1")
        with pytest.raises(RuntimeError, match="has no card"):
            parallel.initialize()
        assert not torch.distributed.is_initialized()


# ---------------- pad rows and their weights ---------------------------------


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 64), world=st.sampled_from([1, 2, 3, 4]))
def test_pad_and_validity_weights_match_jax(n, world):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    np.testing.assert_array_equal(
        pad_batch_to_multiple(torch.tensor(x), world).numpy(),
        np.asarray(jax_pad(jnp.asarray(x), world)))
    np.testing.assert_array_equal(pad_batch_to_multiple(x, world),
                                  np.asarray(jax_pad(jnp.asarray(x), world)))
    want = jax_weights(n, world)
    got = batch_validity_weights(n, world)
    if want is None:
        assert got is None
        assert all(batch_validity_weights(n, world, rank_mesh(r, world))
                   is None for r in range(world))
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per = -(-n // world)
    blocks = [batch_validity_weights(n, world, rank_mesh(r, world))
              for r in range(world)]
    np.testing.assert_array_equal(torch.cat(blocks).numpy(),
                                  np.asarray(want))
    for r, block in enumerate(blocks):
        real = min(max(n - r * per, 0), per)
        assert block.shape == (per,) and int(block.sum()) == real
        # the loaders' slice of the same global batch: its real rows are
        # the block's ones, the repeats of the last index its zeros
        idx = process_local_indices(np.arange(n), r, world)
        assert len(idx) == per
        np.testing.assert_array_equal(idx[:real], np.arange(n)[
            r * per:r * per + real])


def test_shard_batch_and_the_loaders_global_rows():
    x = np.arange(10, dtype=np.float32)[:, None] * np.ones((10, 4))
    labels = ["a"] * 10
    parts = shard_batch((x, labels), make_mesh((4, 1), devices=["cpu"] * 4))
    assert [p[0].shape[0] for p in parts] == [3, 3, 3, 3]
    assert parts[0][1] == labels                    # labels pass
    merged = torch.cat([p[0] for p in parts]).numpy()
    np.testing.assert_array_equal(merged, np.asarray(
        jax_shard(jnp.asarray(x), jax_make_mesh((4, 1),
                                                devices=jax.devices()[:4]))))
    rows = [shard_batch(x, rank_mesh(r, 4)) for r in range(4)]
    np.testing.assert_array_equal(torch.cat(rows).numpy(), merged)
    local = x[3:6]
    assert torch.equal(global_batch_from_local(local, rank_mesh(1, 4)),
                       torch.tensor(local))
    (got, w) = rank_batch(x, rank_mesh(3, 4))
    np.testing.assert_array_equal(got.numpy(), merged[9:])
    np.testing.assert_array_equal(w.numpy(), [1, 0, 0])
    (got, w) = rank_batch(local, rank_mesh(1, 4), global_rows=10)
    np.testing.assert_array_equal(w.numpy(), [1, 1, 1])
    loader = EpochBatches(list(range(10)), 4, shuffle=False,
                          process_index=1, process_count=2)
    assert [loader.global_rows(i) for i in range(len(loader))] == [4, 4, 2]
    assert loader_global_rows(loader, 2, rank_mesh(1, 2)) == 2
    assert loader_global_rows(list(range(3)), 0, rank_mesh(1, 2)) is None
    with pytest.raises(ValueError, match="sliced for 2 processes"):
        loader_global_rows(loader, 0, rank_mesh(1, 4))
    # the trainers' step placement: one process takes the rows as given
    (got, w) = step_rows(x, make_mesh(devices=["cpu"]), loader, 2)
    assert w is None and torch.equal(got, torch.tensor(x))
    nine = EpochBatches(list(range(9)), 4, shuffle=False, process_index=1,
                        process_count=2)            # last batch: 1 real row
    (got, w) = step_rows(local[:1], rank_mesh(1, 2), nine, 2)
    np.testing.assert_array_equal(w.numpy(), [0])
    (got, w) = step_rows(x[:7], rank_mesh(1, 2), list(range(3)), 0)
    np.testing.assert_array_equal(got.numpy(), x[[4, 5, 6, 6]])
    np.testing.assert_array_equal(w.numpy(), [1, 1, 1, 0])


def test_a_group_started_elsewhere_never_lands_on_the_cpu(tmp_path,
                                                          monkeypatch):
    """A gloo group started by hand names no device: the mesh asks for
    one, a trainer left at the card gets the card (here, with none, the
    error), and the CPU only when asked for."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
        rank=0)
    try:
        with pytest.raises(RuntimeError, match="names no device"):
            make_mesh()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                LDMTrainer(tiny(default_config()), perceptual=False)
        mesh = training_mesh(default_config().mesh, device="cpu")
        assert mesh.distributed and mesh.device == CPU
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        assert process_device("cuda") == torch.device("cuda", 0)
        assert process_device("cuda:1") == torch.device("cuda", 1)
    finally:
        torch.distributed.destroy_process_group()


def test_device_resident_pairs_per_rank_gathers_reassemble(tmp_path):
    """Each rank gathers its own rows of every global batch from the
    whole corpus on its device; the ranks' rows, cropped of the repeats,
    are the one-process batches (tests/test_multihost.py:114-131)."""
    n = 10
    imgs = (np.arange(n)[:, None, None] * np.ones((n, 8, 8))).astype(np.uint8)
    jax_write_pack(tmp_path / "t.spk", imgs, np.zeros(n, np.uint16), ["a"])
    pairs = tmp_path / "pairs.csv"
    pairs.write_text("\n".join(f"a,{i},a,{(3 * i + 1) % n}"
                               for i in range(7)) + "\n")
    whole = DeviceResidentPairs(tmp_path / "t.spk", pairs, crop=8,
                                device="cpu")
    want = list(DevicePairLoader(whole, 4, seed=3))
    world = 3
    ranks = [list(DevicePairLoader(DeviceResidentPairs(
        tmp_path / "t.spk", pairs, crop=8, mesh=rank_mesh(r, world)), 4,
        seed=3)) for r in range(world)]
    for i, ((c, lc), (s, ls)) in enumerate(want):
        per = -(-len(c) // world)
        got_c = torch.cat([rk[i][0][0] for rk in ranks])
        got_s = torch.cat([rk[i][1][0] for rk in ranks])
        assert all(len(rk[i][0][0]) == per for rk in ranks)
        assert torch.equal(got_c[:len(c)], c) and torch.equal(
            got_s[:len(s)], s)
        assert torch.equal(got_c[len(c):], c[-1:].expand(
            per * world - len(c), -1, -1, -1))


# ---------------- masked BatchNorm -------------------------------------------


@pytest.mark.parametrize("n_real", [5, 8])
def test_masked_batchnorm_matches_flax(n_real):
    """Output and running statistics of a padded batch with its mask
    against flax's masked BatchNorm (tests/test_padding_mask.py:71-90);
    garbage in the pad rows changes neither."""
    rng = np.random.RandomState(n_real)
    x = (1.0 + 2.0 * rng.randn(8, 6, 6, 16)).astype(np.float32)
    x[n_real:] = 50.0 * rng.rand(8 - n_real, 6, 6, 16)
    w = np.asarray([1.0] * n_real + [0.0] * (8 - n_real), np.float32)
    scale, bias = rng.rand(16) + 0.5, rng.randn(16)
    mean, var = rng.randn(16), rng.rand(16) + 0.5
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32),
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}})
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    want, upd = bn.apply(variables, x, mask=w.reshape(-1, 1, 1, 1) > 0,
                         mutable=["batch_stats"])
    port = BatchNorm(16)
    with torch.no_grad():
        for t, a in ((port.weight, scale), (port.bias, bias),
                     (port.running_mean, mean), (port.running_var, var)):
            t.copy_(torch.tensor(a))
    got = port(torch.tensor(x).permute(0, 3, 1, 2), train=True,
               mask=torch.tensor(w))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-5)
    for t, key in ((port.running_mean, "mean"), (port.running_var, "var")):
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=RTOL, atol=STATS_ATOL)


# ---------------- the padded tail batch of the trainers ----------------------


def _ae_to_flax(model, cfg):
    holder = build_ldm(cfg, device="cpu", seed=1)
    for comp in AE:
        getattr(holder, comp).load_state_dict(
            getattr(model, comp).state_dict())
    v = jax.tree_util.tree_map(np.array, export_flax_variables(holder))
    return {kind: {comp: v[kind][comp] for comp in AE}
            for kind in ("params", "batch_stats")}


def test_ae_tail_batch_matches_the_jax_mesh():
    """5 rows padded to 8 with their weights: the port's step against the
    JAX AETrainer's on a (4, 1) mesh (tests/test_padding_mask.py:93-124):
    the validation loss, the training loss and the running statistics.

    After the step, Adam moves a parameter whose true gradient is 0 (a
    conv bias feeding a train-mode BatchNorm) by up to its learning rate
    on rounding noise, so the validation loss of the updated weights
    differs by ~1e-4 relative between the JAX package's own (1, 1) and
    (4, 1) meshes; it is held at that test's 1e-3."""
    rng = np.random.RandomState(0)
    cfg = tiny(default_config())
    trainer = AETrainer(cfg, perceptual=False, device="cpu")
    state = trainer.init_state(0)
    variables = _ae_to_flax(state.model, cfg)
    jmesh = jax_make_mesh((4, 1), devices=jax.devices()[:4])
    jtr = JaxAETrainer(tiny(jax_config()), mesh=jmesh, perceptual=False)
    jstate = jtr.init_state(0).replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=jtr.tx.init(variables["params"]))
    x = rng.rand(5, 64, 64, 1).astype(np.float32)
    jw = jax_weights(5, 4, jmesh)
    xp = jax_shard(jnp.asarray(x), jmesh)
    w = batch_validity_weights(5, 4)
    xt = pad_batch_to_multiple(torch.tensor(x), 4)
    np.testing.assert_allclose(
        trainer._eval(state, xt, w).item(),
        float(jtr._val_step(jstate, xp, None, jw)), rtol=RTOL)
    state, loss = trainer._step(state, xt, w)
    jstate, jloss = jtr._train_step(jstate, xp, None, jw)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    got = dict(jax.tree_util.tree_leaves_with_path(
        _ae_to_flax(state.model, cfg)["batch_stats"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jstate.batch_stats):
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=RTOL,
                                   atol=STATS_ATOL, err_msg=str(path))
    np.testing.assert_allclose(
        trainer._eval(state, xt, w).item(),
        float(jtr._val_step(jstate, xp, None, jw)), rtol=1e-3)


def test_ldm_step_invariant_to_pad_row_contents():
    """The whole LDM step with both perceptual metrics: garbage in the pad
    rows in place of repeats changes no metric (the same step draws;
    tests/test_padding_mask.py:127-156)."""
    rng = np.random.RandomState(1)
    cfg = tiny(default_config())
    trainer = LDMTrainer(cfg, perceptual=True, device="cpu")
    content = rng.rand(5, 64, 64, 1).astype(np.float32)
    style = rng.rand(5, 64, 64, 1).astype(np.float32)
    garbage = 10.0 * rng.rand(3, 64, 64, 1).astype(np.float32)
    w = batch_validity_weights(5, 4)

    def step(filler_c, filler_s):
        c = torch.tensor(np.concatenate([content, filler_c]))
        s = torch.tensor(np.concatenate([style, filler_s]))
        st_, metrics = trainer._step(trainer.init_state(0), c, s, weights=w)
        stats = {k: v.clone() for k, v in st_.model.decoder.state_dict()
                 .items() if "running" in k}
        return metrics, stats

    m_rep, s_rep = step(np.repeat(content[-1:], 3, 0),
                        np.repeat(style[-1:], 3, 0))
    m_bad, s_bad = step(garbage, garbage)
    for k in m_rep:
        np.testing.assert_allclose(m_bad[k].item(), m_rep[k].item(),
                                   rtol=RTOL, err_msg=k)
    for k in s_rep:
        np.testing.assert_allclose(s_bad[k].numpy(), s_rep[k].numpy(),
                                   rtol=RTOL, atol=STATS_ATOL, err_msg=k)


# ---------------- the meshed serving engine ----------------------------------


@pytest.fixture(scope="module")
def ldm_pair():
    rng = np.random.RandomState(7)
    model = JaxLDM(dtype=jnp.float32)
    x = jnp.asarray(rng.rand(1, 128, 128, 1), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "diffusion": jax.random.PRNGKey(1)},
                           x, x, jnp.zeros((1,), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = build_ldm(device="cpu")
    load_flax_variables(port, variables)
    return model, variables, port


def _jax_keys(seeds):
    """The JAX engine's per-item keys of 64-bit seeds."""
    u = np.asarray(seeds).astype(np.uint64)
    lo = jnp.asarray((u & 0x7FFFFFFF).astype(np.int32))
    hi = jnp.asarray(((u >> 31) & 0x7FFFFFFF).astype(np.int32))
    return jax.vmap(
        lambda a, b: jax.random.fold_in(jax.random.PRNGKey(a), b))(lo, hi)


def test_meshed_engine_matches_the_jax_mesh(ldm_pair, monkeypatch):
    """Two CPU replicas against the JAX engine on a (2, 1) mesh: buckets
    rounded up to multiples of 2, the fused route bypassed, each row
    equal to JAX's with that row's own noise (injected: the two RNGs
    cannot agree), three rows padded to the bucket of four."""
    model, variables, port = ldm_pair
    rng = np.random.RandomState(3)
    content = rng.rand(3, 128, 128, 1).astype(np.float32)
    style = rng.rand(3, 128, 128, 1).astype(np.float32)
    seeds = np.asarray([11, 12, 13])
    quick = dict(steps=12, sampler="fused", invert_audio=False,
                 batch_buckets=(1, 3))
    jeng = JaxEngine(model, variables, JaxEngineConfig(**quick),
                     mesh=jax_make_mesh((2, 1), devices=jax.devices()[:2]))
    assert jeng.config.batch_buckets == (2, 4)
    jeng._warm_buckets = {4}         # JAX compiles only the bucket used
    want = jeng.transfer_batch(content, style, seeds)["image"]

    z0 = model.apply(variables, jnp.asarray(content), method=JaxLDM.encode)
    keys = _jax_keys(seeds)
    noise = np.asarray(jax.vmap(lambda k, z: jax.random.normal(
        k, z.shape, jnp.float32))(keys, z0))
    by_seed = {int(s): torch.tensor(noise[i]) for i, s in enumerate(seeds)}
    calls, scan = [], engine_mod.transfer_decoded

    def injected(ldm, c, s, *a, seeds, **k):
        calls.append((ldm, c.shape[0]))
        rows = torch.stack([by_seed[int(x)] for x in seeds])
        return scan(ldm, c, s, *a, noise=rows, **k)
    monkeypatch.setattr(engine_mod, "transfer_decoded", injected)
    eng = InferenceEngine(port, EngineConfig(**quick),
                          mesh=make_mesh((2, 1), devices=["cpu", "cpu"]))
    assert eng.config.batch_buckets == (2, 4)
    assert len(eng.replicas) == 2 and eng.replicas[0] is port
    assert eng.replicas[1] is not port
    assert not any(eng.uses_fused(b) for b in (1, 2, 4))
    eng._warm_buckets = frozenset({4})
    got = eng.transfer_batch(content, style, seeds)["image"]
    assert got.shape == (3, 128, 128, 1)
    # two replicas, two rows each: the bucket of four split in order
    assert [(c[0] is port, c[1]) for c in calls] == [(True, 2), (False, 2)]
    np.testing.assert_allclose(got, want, atol=TRANSFER_ATOL)
    # a row's result does not depend on its replica: row 0 on replica 1
    alone = eng.transfer_batch(content[[2, 2, 0]], style[[2, 2, 0]],
                               seeds[[2, 2, 0]])["image"]
    np.testing.assert_allclose(alone[2], got[0], atol=1e-5)
    # with audio (NNLS and Griffin-Lim on each replica): every row as one
    # replica gives it at the replicas' batch, the pad row included
    meng = InferenceEngine(port, EngineConfig(**dict(quick,
                                                     invert_audio=True)),
                           mesh=make_mesh((2, 1), devices=["cpu", "cpu"]))
    meng._warm_buckets = frozenset({4})
    one = InferenceEngine(port, EngineConfig(**dict(
        quick, sampler="ddim", invert_audio=True, batch_buckets=(1, 2))))
    one._warm_buckets = frozenset({2})
    meshed = meng.transfer_batch(content, style, seeds)
    blocks = [one.transfer_batch(content[r], style[r], seeds[r])
              for r in ([0, 1], [2, 2])]
    for key in ("image", "audio"):
        by_block = np.concatenate([o[key] for o in blocks])[:3]
        np.testing.assert_allclose(meshed[key], by_block, atol=1e-6,
                                   err_msg=key)
    with pytest.raises(ValueError, match="one process"):
        InferenceEngine(port, EngineConfig(**quick), mesh=rank_mesh(0, 2))


def test_serve_mesh_dp_builds_replicas_and_refuses_missing_cards():
    p = cli.build_parser()
    args = p.parse_args(["serve", "--checkpoint", "c", "--mesh-dp", "2",
                         "--device", "cpu"])
    mesh = cli.serving_mesh(args)
    assert mesh.size == 2 and mesh.devices == (CPU, CPU)
    assert cli.serving_mesh(p.parse_args(["serve", "--checkpoint", "c"])
                            ) is None
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    args = p.parse_args(["serve", "--checkpoint", "c", "--mesh-dp",
                         str(max(cards + 1, 2))])
    with pytest.raises(SystemExit, match="card"):
        cli.serving_mesh(args)
    with pytest.raises(SystemExit, match="at least 1"):
        cli.serving_mesh(types.SimpleNamespace(mesh_dp=0, device="cpu"))
