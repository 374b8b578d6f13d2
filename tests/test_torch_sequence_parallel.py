"""The port's sequence parallelism and its wide-clip draws (CPU).

Wide clips first, in one process: the LDM trainer's and the distiller's
steps on a 64 x 256 batch at image_size=64, against the JAX package's
steps on the same injected draws (the noise is shaped like the batch's
own latent, 8 x 32), and the square batch's draws as they always were.

Then width-sharded runs in spawned gloo ranks (``test_torch_distributed
.spawn``), one torch thread each:

* (1, 4): each conv geometry alone on width blocks with halos (both
  clip edges and interior ranks), forward and input gradient, against
  the unsharded conv; the encoder, and the style pyramid with the UNet at
  a width whose blocks turn odd (the UNet's enc4 and the pyramid's s6
  gather to the whole width there), against one process;
* (2, 2): the LDM step on 64 x 256 against the port's one-process step
  and the JAX single-device step, the trainer's epoch with
  ``sequence_parallel=True`` and its own draws, and the 128 x 1024
  forward (the JAX package's ``tests/test_parallel.py`` cases).
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_style_transfer_ldm_tpu.config import default_config as jax_config
from music_style_transfer_ldm_tpu.parallel import make_mesh as jax_make_mesh
from music_style_transfer_ldm_tpu.parallel import shard_batch as jax_shard
from music_style_transfer_ldm_tpu.training import LDMTrainer as JaxTrainer
from music_style_transfer_ldm_tpu.training import distill as jax_distill
from music_style_transfer_ldm_tpu.training.state import (
    TrainState as JaxTrainState,
)
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs, export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.autoencoder import (
    SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.layers import (
    BatchNorm, conv_s1, conv_s2, convT_k3, convT_k4, width_halo,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.models.style_encoder import (
    StyleEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.unet import UNet
from music_style_transfer_ldm_tpu_torch.parallel import Mesh, shard_batch
from music_style_transfer_ldm_tpu_torch.training import (
    LDMTrainer, ProgressiveDistiller,
)
from music_style_transfer_ldm_tpu_torch.training.train_ldm import step_seed
from test_torch_distributed import spawn

RTOL_LOSS = 1e-5       # the port's steps against each other, f32
GRAD_OF_MAX = 1e-4     # per parameter: max abs error / its max |grad|
RTOL_STATS, ATOL_STATS = 1e-5, 1e-6
ZERO_FLOOR = 1e-5      # of the largest gradient: the true gradient is 0
# Against the JAX single-device step, the JAX package's own bars for its
# sharded step (tests/test_parallel.py): losses rtol 2e-4, gradients
# rtol 5e-3 with atol 1e-8 + 2e-4 x max, BatchNorm rtol 1e-3 atol 1e-5.
# A parameter whose true gradient is 0 (a bias before a train-mode
# BatchNorm, attention's key bias) holds rounding on both sides, and is
# held below ZERO_FLOOR of the largest gradient, as the port's tests do.
JAX_RTOL_LOSS, JAX_RTOL_GRAD, JAX_GRAD_OF_MAX = 2e-4, 5e-3, 2e-4
JAX_RTOL_BN, JAX_ATOL_BN = 1e-3, 1e-5
# The 128 x 1024 forward (tests/test_parallel.py): rtol 1e-4, atol 1e-5
# on the reconstruction and 2e-5 on the noise prediction.
FWD_RTOL, FWD_ATOL_REC, FWD_ATOL_EPS = 1e-4, 1e-5, 2e-5
LAYER_ATOL = 1e-5      # one conv or the encoder, f32
# The decoder's train-mode path (ReLU after BatchNorm) on a 64 x 256
# batch: its ReLUs see about 2M values a step, so a few lie within f32
# rounding of 0 and a gate can flip between two f32 implementations that
# sum in other orders (tools/torch_wide_near_ties.py counts them against
# a decoder with float64 convs).  A flip moves a decoder gradient by more
# than 1e-4 of its max but a small share of its norm, so the decoder's
# gradients are held by relative L2 at 1e-3 (the bar the repo keeps for
# near-tie routing: kernel E's max-pools, chip_smoke.py), every other
# gradient at the bars above.
NEAR_TIE_L2 = 1e-3
NEAR_TIE_PREFIX = "decoder."
B, H, W = 4, 64, 256   # the wide batch (two rows per data index at (2, 2))
STAGE = (4, 2)
CPU = torch.device("cpu")
GEOMETRIES = {"conv_s1": conv_s1, "conv_s2": conv_s2, "convT_k3": convT_k3,
              "convT_k4": convT_k4}

_WORKER = r'''
"""One rank: python worker.py RANK WORLD STORE SPEC OUT N M."""
import dataclasses
import sys

import torch

torch.set_num_threads(1)

from music_style_transfer_ldm_tpu_torch import parallel
from music_style_transfer_ldm_tpu_torch.config import default_config
from music_style_transfer_ldm_tpu_torch.models import layers
from music_style_transfer_ldm_tpu_torch.models.autoencoder import (
    SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm
from music_style_transfer_ldm_tpu_torch.models.style_encoder import (
    StyleEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.unet import UNet
from music_style_transfer_ldm_tpu_torch.parallel import shard_batch
from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    gather, model_axis,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    gather_tensors, gathered_state_dict, local_blocks, rank_batch,
    split_dims, width_block,
)
from music_style_transfer_ldm_tpu_torch.training import LDMTrainer

GEOMETRIES = {"conv_s1": layers.conv_s1, "conv_s2": layers.conv_s2,
              "convT_k3": layers.convT_k3, "convT_k4": layers.convT_k4}


def tiny(shape):
    cfg = default_config()
    cfg.train = dataclasses.replace(cfg.train, batch_size=4,
                                    compute_dtype="float32")
    cfg.model = dataclasses.replace(cfg.model, image_size=64)
    cfg.mesh = dataclasses.replace(cfg.mesh, mesh_shape=shape,
                                   sequence_parallel=True)
    return cfg


def nchw_block(x, mesh):
    """This rank's width block of an NHWC array, as NCHW."""
    return width_block(torch.as_tensor(x), mesh).permute(0, 3, 1, 2)


def whole_grads(module, mesh):
    grads = {k: p.grad for k, p in module.named_parameters()
             if p.grad is not None}
    return gather_tensors(grads, split_dims(module), mesh)


def layer_runs(spec, mesh, ax):
    res = {}
    for name, make in GEOMETRIES.items():
        torch.manual_seed(0)
        conv = make(3, 5)
        x = nchw_block(spec["x"], mesh).contiguous().requires_grad_(True)
        y = layers.conv(conv, x, ax)
        g = torch.as_tensor(spec["g_" + name]).chunk(ax.size, -1)
        (y * g[ax.index]).sum().backward()
        res[name] = (y.detach(), x.grad)
    enc = SpectrogramEncoder(32)
    enc.load_state_dict(spec["encoder"])
    x = nchw_block(spec["img"], mesh).contiguous().requires_grad_(True)
    z = enc(x, ax=ax)
    (z * torch.as_tensor(spec["g_enc"]).chunk(ax.size, -1)[ax.index]
     ).sum().backward()
    res["encoder"] = (gather(z.detach(), -1, ax), x.grad,
                      {k: p.grad for k, p in enc.named_parameters()})
    se, unet = StyleEncoder(64), UNet(32, 32)
    se.load_state_dict(spec["style_encoder"])
    unet.load_state_dict(spec["unet"])
    emb = se(nchw_block(spec["img"], mesh), ax)
    z = nchw_block(spec["lat"], mesh).contiguous().requires_grad_(True)
    out = unet(z, torch.as_tensor(spec["t"]).long(), emb, ax)
    (out * torch.as_tensor(spec["g_unet"]).chunk(ax.size, -1)[ax.index]
     ).sum().backward()
    res["unet"] = (gather(out.detach(), -1, ax), z.grad,
                   {k: p.grad for k, p in list(unet.named_parameters())
                    + [("se." + k, p) for k, p in se.named_parameters()]
                    if p.grad is not None})
    return res


def step_runs(spec, mesh, ax, shape):
    res = {}
    cfg = tiny(shape)
    tr = LDMTrainer(cfg, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(local_blocks(spec["ldm"], split_dims(st.model),
                                          mesh))
    (c, s), w = rank_batch((torch.as_tensor(spec["content"]),
                            torch.as_tensor(spec["style"])), mesh,
                           sequence_parallel=True)
    t, noise = shard_batch((torch.as_tensor(spec["t"]),
                            torch.as_tensor(spec["noise"])), mesh)
    res["width"] = tuple(c.shape)
    st, met = tr._step(st, c, s, t=t.long(), noise=noise)
    res["step"] = {"metrics": {k: v.item() for k, v in met.items()},
                   "grads": whole_grads(st.model, mesh),
                   "stats": {k: v for k, v in gathered_state_dict(
                       st.model.decoder, mesh).items() if "running" in k}}
    tr = LDMTrainer(cfg, perceptual=False, device="cpu")
    st = tr.init_state(0)
    batch = [((spec["content"][:2], [0, 0]), (spec["style"][:2], [1, 1]))]
    st, avgs = tr.train_epoch(st, batch)
    res["epoch"] = avgs
    ldm = build_ldm(tiny(shape), device="cpu", seed=0)
    with torch.no_grad():
        x, sty = shard_batch((torch.as_tensor(spec["wide"]),
                              torch.as_tensor(spec["wide_style"])), mesh,
                             sequence_parallel=True)
        eps, = shard_batch((torch.as_tensor(spec["wide_noise"]),), mesh)
        out = ldm(x, sty, torch.zeros(x.shape[0], dtype=torch.long),
                  noise=eps, ax=ax)
    res["forward"] = {k: out[k] for k in ("noise_pred", "reconstructed")}
    return res


def main():
    rank, world, store, spec_path, out, n, m = sys.argv[1:8]
    shape = (int(n), int(m))
    assert parallel.initialize(store, int(world), int(rank), device="cpu")
    spec = torch.load(spec_path, weights_only=False)
    mesh = parallel.make_mesh(shape)
    ax = model_axis(mesh, sequence=True)
    res = (layer_runs(spec, mesh, ax) if spec["mode"] == "layers"
           else step_runs(spec, mesh, ax, shape))
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


def _grads_close(got, want, tol=GRAD_OF_MAX, near_ties=False):
    """Per parameter: max abs error <= tol x its max |grad| (a parameter
    whose true gradient is 0: within ZERO_FLOOR of the largest); with
    ``near_ties`` the decoder's by relative L2 (NEAR_TIE_L2).  Returns
    the number held at ``tol``."""
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    n = 0
    for name, w in want.items():
        w, g = np.asarray(w), np.asarray(got[name])
        scale = float(np.abs(w).max())
        if scale < ZERO_FLOOR * top:
            assert float(np.abs(g).max()) < ZERO_FLOOR * top, name
            continue
        if near_ties and name.startswith(NEAR_TIE_PREFIX):
            rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
            assert rel < NEAR_TIE_L2, (name, rel)
            continue
        err = float(np.abs(g - w).max()) / scale
        assert err < tol, (name, err)
        n += 1
    return n


def _capture_grads(*args, **kwargs):
    """An optax transformation whose state after a step is the gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, state, params=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _as_port(cfg, params, stats):
    """A flax-layout tree -> the port's parameter names, as numpy."""
    holder = build_ldm(cfg, device="cpu", seed=1)
    load_flax_variables(holder, {"params": params, "batch_stats": stats})
    return ({k: p.detach().numpy() for k, p in holder.named_parameters()},
            {k: v.numpy() for k, v in holder.decoder.state_dict().items()
             if "running" in k})


def _port_step(cfg, ldm, c, s, t, noise, stat_dtype=torch.float32):
    """The port's one-process LDM step with injected draws."""
    from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm
    saved, nm.STAT_DTYPE = nm.STAT_DTYPE, stat_dtype
    try:
        tr = LDMTrainer(cfg, device="cpu")
        st = tr.init_state(0)
        st.model.load_state_dict(ldm.state_dict())
        st, met = tr._step(st, torch.tensor(c), torch.tensor(s),
                           t=torch.tensor(t).long(),
                           noise=torch.tensor(noise))
    finally:
        nm.STAT_DTYPE = saved
    return {"metrics": {k: v.item() for k, v in met.items()},
            "grads": {k: p.grad.numpy() for k, p in
                      st.model.named_parameters() if p.grad is not None},
            "stats": {k: v.numpy() for k, v in
                      st.model.decoder.state_dict().items()
                      if "running" in k}}


@pytest.fixture(scope="module")
def wide():
    """The wide batch, the JAX single-device LDM and distill steps on it,
    and the port's one-process steps with the same draws."""
    torch.set_num_threads(2)
    rng = np.random.RandomState(0)
    cfg = tiny()
    ldm = build_ldm(cfg, device="cpu", seed=0)
    _randomise_stats(ldm, rng)
    c, s = (rng.rand(B, H, W, 1).astype(np.float32) for _ in range(2))
    t = np.asarray([3, 50, 120, 199], np.int32)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       export_flax_variables(ldm))
    jtr = JaxTrainer(tiny(jax_config()),
                     mesh=jax_make_mesh((1, 1), devices=jax.devices()[:1]),
                     perceptual=True)
    port = LDMTrainer(cfg, device="cpu")
    fparams = (export_flax_convs(port.compression_feature.module),
               export_flax_convs(port.style_feature.module))
    drng = jax.random.PRNGKey(5)
    (_, (metrics, new_stats)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bs, cc, ss, tt, fp: jtr._losses(p, bs, cc, ss, tt, drng,
                                                  fp),
        has_aux=True))(variables["params"], variables["batch_stats"], c, s,
                       t, fparams)
    noise = np.asarray(jtr.model.apply(
        variables, c, s, t, train=True, frozen_encoder=True,
        rngs={"diffusion": drng}, mutable=["batch_stats"])[0]["noise"])
    grads, _ = _as_port(cfg, jgrads, variables["batch_stats"])
    _, stats = _as_port(cfg, variables["params"], new_stats)
    jax_step = {"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {k: v for k, v in grads.items()
                          if not k.startswith("encoder.")},
                "stats": stats}

    jd = jax_distill.ProgressiveDistiller(tiny(jax_config()),
                                          mesh=jax_make_mesh((-1, 1)),
                                          t_max=100)
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
    new_state, dmetrics = step(state, variables["params"], jnp.asarray(c),
                               jnp.asarray(s), key)
    ikey, nkey = jax.random.split(key)
    holder = build_ldm(cfg, device="cpu", seed=1)
    load_flax_variables(holder, {
        "params": jax.tree_util.tree_map(np.asarray, new_state.opt_state),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              variables["batch_stats"])})
    jax_distill_step = {
        "loss": float(dmetrics["distill_loss"]),
        "grads": {k: p.detach().numpy()
                  for k, p in holder.unet.named_parameters()},
        "segment": np.asarray(jax.random.randint(ikey, (B,), 0, STAGE[1])),
        # the JAX step draws its noise shaped like the batch's latent
        "noise": np.asarray(jax.random.normal(nkey, (B, 8, W // 8, 32),
                                              jnp.float32))}
    return {"cfg": cfg, "ldm": ldm, "c": c, "s": s, "t": t, "noise": noise,
            "jax": jax_step, "jax_distill": jax_distill_step,
            "port": _port_step(cfg, ldm, c, s, t, noise),
            "oracle": _port_step(cfg, ldm, c, s, t, noise, torch.float64)}


# ---------------- wide-clip draws, one process -------------------------------


def test_ldm_step_on_a_wide_clip_matches_jax(wide):
    """The port's 64 x 256 step against the JAX step on the same draws, at
    test_torch_training.py's bars: losses 1e-5, gradients 1e-4 of max
    (the VGGish terms to the port's float64-statistics oracle at 1e-5
    and to JAX at test_torch_distributed.py's 1e-4; the decoder's
    gradients by NEAR_TIE_L2)."""
    got, want, oracle = wide["port"], wide["jax"], wide["oracle"]
    for k, v in want["metrics"].items():
        rtol = RTOL_LOSS if k in ("compression_loss", "denoising_loss") \
            else 1e-4
        assert abs(got["metrics"][k] - v) <= rtol * abs(v), k
        assert abs(got["metrics"][k] - oracle["metrics"][k]) <= (
            RTOL_LOSS * abs(v)), k
    assert _grads_close(got["grads"], want["grads"], near_ties=True) > 20
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=RTOL_STATS,
                                   atol=ATOL_STATS, err_msg=k)


def test_distill_step_on_a_wide_clip_matches_jax(wide):
    cfg, want = wide["cfg"], wide["jax_distill"]
    dist = ProgressiveDistiller(cfg, t_max=100, device="cpu")
    student = build_ldm(cfg, device="cpu", seed=0)
    student.load_state_dict(wide["ldm"].state_dict())
    student.requires_grad_(False)
    student.unet.requires_grad_(True)
    stage = dist.start_stage(student, 0, *STAGE, 1e-3)
    shapes = []

    def draws(seed, stage_index, step, batch, n_student, latent_shape):
        shapes.append(tuple(latent_shape))
        return (torch.tensor(want["segment"]).long(),
                torch.tensor(want["noise"]))

    dist.draws = draws
    loss = dist.step(student, stage, torch.tensor(wide["c"]),
                     torch.tensor(wide["s"]), 0, 0).item()
    assert shapes == [(8, 32, 32)]
    assert abs(loss - want["loss"]) <= RTOL_LOSS * abs(want["loss"])
    got = {k: p.grad.numpy() for k, p in student.unet.named_parameters()}
    assert _grads_close(got, want["grads"]) > 20


def test_draws_take_the_batch_latent_and_keep_square_draws():
    cfg = tiny(style_dropout=0.5)
    tr = LDMTrainer(cfg, perceptual=False, device="cpu")
    square = tr.draws(3, 4)
    # the square batch's draws as they were drawn before the latent shape
    # came from the batch: t, then [n, 8, 8, 32] noise, then the mask
    gen = torch.Generator().manual_seed(step_seed(cfg.train.seed, 3))
    t = torch.randint(0, 200, (4,), generator=gen)
    noise = torch.randn((4, 8, 8, 32), generator=gen)
    mask = (torch.rand(4, generator=gen) < 0.5).float()
    for got, want in zip(square, (t, noise, mask)):
        assert torch.equal(got, want)
    content = torch.zeros(4, 64, 64, 1)
    for got, want in zip(tr.draws(3, 4, latent_shape=tr.latent_shape(
            content)), square):
        assert torch.equal(got, want)
    t_w, noise_w, _ = tr.draws(3, 4, latent_shape=tr.latent_shape(
        torch.zeros(4, 64, 256, 1)))
    assert torch.equal(t_w, t) and noise_w.shape == (4, 8, 32, 32)
    # a wide clip's own draws run the whole step (they raised before)
    st = tr.init_state(0)
    wide = torch.rand(4, 64, 256, 1)
    st, metrics = tr._step(st, wide, wide)
    assert all(np.isfinite(v.item()) for v in metrics.values())


# ---------------- width blocks -----------------------------------------------


def test_shard_batch_pads_an_odd_width_as_jax():
    x = np.random.RandomState(1).rand(4, 64, 130, 1).astype(np.float32)
    want = np.asarray(jax_shard(jnp.asarray(x), jax_make_mesh((2, 4)),
                                sequence_parallel=True))
    assert want.shape == (4, 64, 132, 1)
    blocks = [[shard_batch(x, Mesh({"data": 2, "model": 4}, (CPU,) * 8,
                                   group=object(), index=d * 4 + j),
                           sequence_parallel=True) for j in range(4)]
              for d in range(2)]
    assert blocks[0][0].shape == (2, 64, 33, 1)
    got = torch.cat([torch.cat(row, 2) for row in blocks]).numpy()
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got[:, :, 130:]).max()) == 0.0


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_width_halo_of_each_geometry(name):
    """The halo each conv reads, derived from its geometry."""
    want = {"conv_s1": (1, 1, 0), "conv_s2": (1, 0, 0),
            "convT_k3": (0, 1, 1), "convT_k4": (1, 1, 3)}
    assert width_halo(GEOMETRIES[name](3, 5)) == want[name]


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    """Each geometry, the encoder and the style pyramid with the UNet on
    (1, 4) width blocks, and the same in one process."""
    torch.set_num_threads(2)
    rng = np.random.RandomState(2)
    spec = {"mode": "layers", "x": rng.rand(2, 6, 16, 3).astype(np.float32),
            "img": rng.rand(2, 64, 128, 1).astype(np.float32),
            "lat": rng.randn(2, 8, 16, 32).astype(np.float32),
            "t": np.asarray([7, 150])}
    one = {}
    for name, make in GEOMETRIES.items():
        torch.manual_seed(0)
        conv = make(3, 5)
        x = torch.tensor(spec["x"]).permute(0, 3, 1, 2).requires_grad_(True)
        y = conv(x)
        g = rng.randn(*y.shape).astype(np.float32)
        spec["g_" + name] = g
        (y * torch.tensor(g)).sum().backward()
        one[name] = (y.detach(), x.grad)
    torch.manual_seed(1)
    enc, se, unet = SpectrogramEncoder(32), StyleEncoder(64), UNet(32, 32)
    spec.update(encoder=enc.state_dict(), style_encoder=se.state_dict(),
                unet=unet.state_dict())
    x = torch.tensor(spec["img"]).permute(0, 3, 1, 2).requires_grad_(True)
    z = enc(x)
    spec["g_enc"] = rng.randn(*z.shape).astype(np.float32)
    (z * torch.tensor(spec["g_enc"])).sum().backward()
    one["encoder"] = (z.detach(), x.grad,
                      {k: p.grad for k, p in enc.named_parameters()})
    emb = se(torch.tensor(spec["img"]).permute(0, 3, 1, 2))
    zl = torch.tensor(spec["lat"]).permute(0, 3, 1, 2).requires_grad_(True)
    out = unet(zl, torch.tensor(spec["t"]), emb)
    spec["g_unet"] = rng.randn(*out.shape).astype(np.float32)
    (out * torch.tensor(spec["g_unet"])).sum().backward()
    one["unet"] = (out.detach(), zl.grad,
                   {k: p.grad for k, p in list(unet.named_parameters())
                    + [("se." + k, p) for k, p in se.named_parameters()]
                    if p.grad is not None})
    d = tmp_path_factory.mktemp("sp_layers")
    ranks = spawn(d, _WORKER, 4, spec, ("1", "4"))
    shutil.rmtree(d)           # the ranks' files are read: free the disk
    return one, ranks


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_conv_on_width_blocks_matches_the_whole_conv(layer_runs, name):
    """Forward and input gradient of one conv on four width blocks (the
    clip's two edges and two interior blocks) against the whole conv."""
    one, ranks = layer_runs
    y = torch.cat([r[name][0] for r in ranks], -1)
    gx = torch.cat([r[name][1] for r in ranks], -1)
    np.testing.assert_allclose(y.numpy(), one[name][0].numpy(),
                               atol=LAYER_ATOL)
    np.testing.assert_allclose(gx.numpy(), one[name][1].numpy(),
                               atol=LAYER_ATOL)


@pytest.mark.parametrize("part", ["encoder", "unet"])
def test_sharded_model_matches_one_process(layer_runs, part):
    """The encoder, and the style pyramid with the UNet at 128-wide
    images on a model axis of 4 (the UNet's enc4 and the pyramid's s6 see
    one-column blocks and gather to the whole width), against one
    process: the output, the input's gradient and every parameter's."""
    one, ranks = layer_runs
    want_y, want_gx, want_g = one[part]
    for r, res in enumerate(ranks):
        y, gx, grads = res[part]
        np.testing.assert_allclose(y.numpy(), want_y.numpy(),
                                   rtol=1e-4, atol=LAYER_ATOL)
        np.testing.assert_allclose(
            gx.numpy(), want_gx.chunk(4, -1)[r].numpy(), rtol=1e-4,
            atol=LAYER_ATOL)
        assert sorted(grads) == sorted(want_g)
        # copy_to_model sums each parameter's gradient over the width
        # blocks: every rank holds the whole one
        assert _grads_close(grads, want_g) > 5


# ---------------- the (2, 2) step, epoch and wide forward --------------------


@pytest.fixture(scope="module")
def step_runs(wide, tmp_path_factory):
    torch.set_num_threads(2)
    rng = np.random.RandomState(3)
    spec = {"mode": "step", "ldm": wide["ldm"].state_dict(),
            "content": wide["c"], "style": wide["s"], "t": wide["t"],
            "noise": wide["noise"],
            "wide": rng.rand(2, 128, 1024, 1).astype(np.float32),
            "wide_style": rng.rand(2, 128, 1024, 1).astype(np.float32),
            "wide_noise": rng.randn(2, 16, 128, 32).astype(np.float32)}
    cfg = wide["cfg"]
    tr = LDMTrainer(cfg, perceptual=False, device="cpu")
    batch = [((wide["c"][:2], [0, 0]), (wide["s"][:2], [1, 1]))]
    _, epoch = tr.train_epoch(tr.init_state(0), batch)
    ldm = build_ldm(cfg, device="cpu", seed=0)
    with torch.no_grad():
        out = ldm(torch.tensor(spec["wide"]), torch.tensor(spec["wide_style"]),
                  torch.zeros(2, dtype=torch.long),
                  noise=torch.tensor(spec["wide_noise"]))
    one = {"epoch": epoch, "forward": out}
    d = tmp_path_factory.mktemp("sp_step")
    ranks = spawn(d, _WORKER, 4, spec, ("2", "2"), timeout=400)
    shutil.rmtree(d)
    return one, ranks


def test_step_places_width_blocks(step_runs):
    assert [r["width"] for r in step_runs[1]] == [(2, H, W // 2, 1)] * 4


def test_sp_step_matches_one_process(wide, step_runs):
    want = wide["port"]
    for res in step_runs[1]:
        got = res["step"]
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) <= RTOL_LOSS * abs(v), k
        assert _grads_close({k: g.numpy() for k, g in got["grads"].items()},
                            want["grads"], near_ties=True) > 20
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v,
                                       rtol=RTOL_STATS, atol=ATOL_STATS,
                                       err_msg=k)


def test_sp_step_matches_the_jax_single_device_step(wide, step_runs):
    want = wide["jax"]
    for res in step_runs[1]:
        got = res["step"]
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v,
                                       rtol=JAX_RTOL_LOSS, err_msg=k)
        top = max(float(np.abs(w).max()) for w in want["grads"].values())
        for k, w in want["grads"].items():
            g, scale = got["grads"][k].numpy(), float(np.abs(w).max())
            if scale < ZERO_FLOOR * top:       # the true gradient is 0
                assert float(np.abs(g).max()) < ZERO_FLOOR * top, k
            elif k.startswith(NEAR_TIE_PREFIX):
                rel = float(np.linalg.norm(g - w) / np.linalg.norm(w))
                assert rel < NEAR_TIE_L2, (k, rel)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=JAX_RTOL_GRAD,
                    atol=1e-8 + JAX_GRAD_OF_MAX * scale, err_msg=k)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v,
                                       rtol=JAX_RTOL_BN, atol=JAX_ATOL_BN,
                                       err_msg=k)


def test_sp_epoch_with_its_own_draws_matches_one_process(step_runs):
    one, ranks = step_runs
    for res in ranks:
        for k, v in one["epoch"].items():
            assert np.isfinite(res["epoch"][k])
            assert abs(res["epoch"][k] - v) <= RTOL_LOSS * abs(v), k


def test_sp_wide_clip_forward_matches_one_process(step_runs):
    """A 128 x 1024 clip (8x the training width) through encode -> UNet ->
    decode on width blocks of 512, against the one-process forward."""
    one, ranks = step_runs
    for r, res in enumerate(ranks):
        rows = slice(r // 2, r // 2 + 1)
        got, want = res["forward"], one["forward"]
        assert got["reconstructed"].shape == (1, 128, 1024, 1)
        np.testing.assert_allclose(got["reconstructed"].numpy(),
                                   want["reconstructed"][rows].numpy(),
                                   rtol=FWD_RTOL, atol=FWD_ATOL_REC)
        np.testing.assert_allclose(got["noise_pred"].numpy(),
                                   want["noise_pred"][rows].numpy(),
                                   rtol=FWD_RTOL, atol=FWD_ATOL_EPS)
