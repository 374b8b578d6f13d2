"""The port's samplers and both kernels' plain versions against the JAX
package, on the same weights, latents and grids.

Where the JAX side reaches a Pallas kernel it runs as the JAX suite runs
it on the CPU: the fused trajectory through its plain executor
``reference_ddim_sample`` over ``pack_operands``, the DDIM update in
interpret mode.  The port's wrappers take their plain versions here
because the tensors lie on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.diffusion import ddim as jddim
from music_style_transfer_ldm_tpu.diffusion.dpm import (
    dpm_solver_pp_2m as jdpm,
)
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu.models.ldm import (
    content_style_transfer as jax_transfer,
)
from music_style_transfer_ldm_tpu.ops.pallas import fused_sampler as jfs
from music_style_transfer_ldm_tpu.ops.pallas.ddim_update import (
    fused_ddim_update as jax_ddim_update,
)
from music_style_transfer_ldm_tpu_torch.diffusion import ddim
from music_style_transfer_ldm_tpu_torch.diffusion.dpm import dpm_solver_pp_2m
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (
    LDM, content_style_transfer, transfer_decoded,
)
from music_style_transfer_ldm_tpu_torch.ops import fused_sampler as fs
from music_style_transfer_ldm_tpu_torch.ops.ddim_update import (
    ddim_step_reference, ddim_update_, ddim_update_reference,
    fused_ddim_update, step_scalars,
)

SCAN_ATOL = 1e-4    # latents after a scan trajectory (f32, sum order)
FUSED_ATOL = 1e-5   # fused plain version vs JAX packed executor, DDIM
DPM_ATOL = 1e-4     # ... DPM++(2M), as tests/test_fused_sampler.py uses
UPDATE_ATOL = 1e-6  # one elementwise DDIM step, f32
LOG_ATOL = 1e-4     # per-step logs of a scan trajectory (as SCAN_ATOL)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(5)
    model = JaxLDM(dtype=jnp.float32)
    x = jnp.asarray(rng.rand(1, 128, 128, 1), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "diffusion": jax.random.PRNGKey(1)},
                           x, x, jnp.zeros((1,), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = LDM().eval()
    port.requires_grad_(False)
    load_flax_variables(port, variables)
    styles = rng.rand(4, 128, 128, 1).astype(np.float32)   # 4 styles
    z_t = rng.randn(4, 16, 16, 32).astype(np.float32)
    return model, variables, port, styles, z_t


@pytest.mark.parametrize("n,steps", [(12, None), (50, None), (200, None),
                                     (14, 7), (100, 25), (10, 10)])
def test_grids_match(n, steps):
    np.testing.assert_array_equal(ddim.transfer_time_grid(n, steps),
                                  jddim.transfer_time_grid(n, steps))
    np.testing.assert_array_equal(ddim.generation_time_grid(200, n),
                                  jddim.generation_time_grid(200, n))


def test_duplicate_grid_guards(pair):
    _, _, port, _, _ = pair
    with pytest.raises(ValueError, match="duplicate"):
        ddim.transfer_time_grid(10, 20)
    dup = np.asarray([9, 7, 7, 4, 0], np.int32)
    with pytest.raises(ValueError, match="duplicate"):
        dpm_solver_pp_2m(lambda z, t: z, port.schedule,
                         torch.zeros(1, 32, 16, 16), dup)
    emb = port.style_embed(torch.zeros(1, 128, 128, 1))
    with pytest.raises(ValueError, match="duplicate"):
        fs.pack_operands(port.unet, emb, port.schedule, dup, 0.0,
                         sampler="dpm++")


def test_schedule_matches(pair):
    model, _, port, _, _ = pair
    np.testing.assert_allclose(port.schedule.alpha_bars_np,
                               np.asarray(model.schedule.alpha_bars),
                               rtol=1e-6)  # f32 cumprod order


def _emb(model, variables, styles):
    return model.apply(variables, jnp.asarray(styles),
                       method=JaxLDM.style_embed)


@pytest.mark.parametrize("sampler,eta,n,steps", [
    ("ddim", 0.0, 12, None), ("ddim", 0.5, 12, None),
    ("dpm++", 0.0, 14, None), ("dpm++", 0.0, 14, 7)])
def test_scan_samplers_match_jax(pair, sampler, eta, n, steps):
    model, variables, port, styles, z_t = pair
    emb = _emb(model, variables, styles)
    times = jddim.transfer_time_grid(n, steps)

    def jfn(x, t):
        return model.apply(variables, x, t, emb, method=JaxLDM.denoise)
    if sampler == "ddim":
        want, _ = jddim.ddim_sample(jfn, model.schedule, jnp.asarray(z_t),
                                    times, eta=eta)
    else:
        want, _ = jdpm(jfn, model.schedule, jnp.asarray(z_t), times)

    temb = {k: torch.tensor(np.asarray(v)).permute(0, 3, 1, 2)
            for k, v in emb.items()}

    def tfn(x, t):
        return port.unet(x, t, temb).float()
    x0 = torch.tensor(z_t).permute(0, 3, 1, 2)
    with torch.no_grad():
        if sampler == "ddim":
            got = ddim.ddim_sample(tfn, port.schedule, x0, times, eta=eta)
        else:
            got = dpm_solver_pp_2m(tfn, port.schedule, x0, times)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=SCAN_ATOL)


def _batch(pair, batch):
    """Styles and latents for `batch` elements: the fixture's four, then
    fresh draws."""
    _, _, _, styles, z_t = pair
    rng = np.random.RandomState(11)
    extra = max(0, batch - len(styles))
    styles = np.concatenate([styles, rng.rand(extra, 128, 128, 1)
                             .astype(np.float32)])
    z_t = np.concatenate([z_t, rng.randn(extra, 16, 16, 32)
                          .astype(np.float32)])
    return styles[:batch], z_t[:batch]


@pytest.mark.parametrize("batch,sampler,n,steps,atol", [
    (1, "ddim", 12, None, FUSED_ATOL),
    (4, "ddim", 12, None, FUSED_ATOL),
    (1, "dpm++", 14, 7, DPM_ATOL),
    (4, "dpm++", 14, 7, DPM_ATOL),
    (3, "ddim", 12, None, FUSED_ATOL),
    (8, "ddim", 12, None, FUSED_ATOL),
    (8, "dpm++", 14, 7, DPM_ATOL),
    # distilled students' grids (t_max 100, 1 and 3 steps): a 1-step grid
    # runs its first step as its last; DPM++(2M)'s first step is first
    # order
    (1, "ddim", 100, 2, FUSED_ATOL),
    (4, "ddim", 100, 4, FUSED_ATOL),
    (1, "dpm++", 100, 2, DPM_ATOL),
    (4, "dpm++", 100, 4, DPM_ATOL)])
def test_fused_plain_version_matches_jax(pair, batch, sampler, n, steps,
                                         atol):
    model, variables, port, _, _ = pair
    styles, z_t = _batch(pair, batch)
    emb = _emb(model, variables, styles[:batch])
    times = jddim.transfer_time_grid(n, steps)
    ops, names = jfs.pack_operands(variables["params"]["unet"], emb,
                                   model.schedule, times, 0.0,
                                   dtype=jnp.float32, sampler=sampler,
                                   batch=batch)
    want = jfs.reference_ddim_sample(ops, names, jnp.asarray(z_t[:batch]),
                                     len(times) - 1)
    pops = fs.pack_operands(port.unet, port.style_embed(
        torch.tensor(styles[:batch])), port.schedule, times, 0.0,
        sampler=sampler, batch=batch)
    np.testing.assert_allclose(
        pops.coefs.numpy(), np.asarray(ops[names.index("coefs")]),
        rtol=1e-5, atol=1e-6)  # host f32 vs XLA f32 scalar math
    got = fs.fused_ddim_sample(pops, torch.tensor(z_t[:batch]),
                               len(times) - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("batch", [2, 3, 8])
def test_fused_eta_matches_scan(pair, batch):
    """eta > 0 folds into the same A/B update as the scan DDIM step."""
    port = pair[2]
    styles, z_t = _batch(pair, batch)
    emb = port.style_embed(torch.tensor(styles))
    times = ddim.transfer_time_grid(10)
    ops = fs.pack_operands(port.unet, emb, port.schedule, times, 0.5,
                           batch=batch)
    got = fs.fused_ddim_sample(ops, torch.tensor(z_t), len(times) - 1)
    temb = {k: v.permute(0, 3, 1, 2) for k, v in emb.items()}
    with torch.no_grad():
        want = ddim.ddim_sample(lambda x, t: port.unet(x, t, temb).float(),
                                port.schedule,
                                torch.tensor(z_t).permute(0, 3, 1, 2),
                                times, eta=0.5)
    np.testing.assert_allclose(got.numpy(),
                               want.permute(0, 2, 3, 1).numpy(),
                               atol=FUSED_ATOL)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_update_matches_jax_kernel(eta):
    rng = np.random.RandomState(6)
    x = rng.randn(8, 16, 16, 32).astype(np.float32)
    e = rng.randn(8, 16, 16, 32).astype(np.float32)
    ab_t, ab_n = 0.8740, 0.8790
    want = jax_ddim_update(jnp.asarray(x), jnp.asarray(e),
                           jnp.float32(ab_t), jnp.float32(ab_n),
                           jnp.float32(eta), interpret=True)
    got = ddim_update_reference(torch.tensor(x), torch.tensor(e), ab_t, ab_n,
                                eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=UPDATE_ATOL)
    # On a CPU tensor the wrapper is the plain version and launches nothing.
    before = fused_ddim_update.launches
    np.testing.assert_array_equal(
        fused_ddim_update(torch.tensor(x), torch.tensor(e), ab_t, ab_n,
                          eta).numpy(), got.numpy())
    assert fused_ddim_update.launches == before


@pytest.mark.parametrize("eps_type", ["f32", "bf16"])
@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("log_x0", [False, True])
def test_ddim_update_in_place_matches_jax_kernel(eps_type, eta, log_x0):
    """The sampler's in-place entry against the out-of-place wrapper and
    the JAX Pallas kernel in interpret mode; bf16 eps is given to JAX as
    its exact f32 value."""
    rng = np.random.RandomState(7)
    x = rng.randn(8, 16, 16, 32).astype(np.float32)
    e = torch.tensor(rng.randn(8, 16, 16, 32).astype(np.float32))
    if eps_type == "bf16":
        e = e.bfloat16()
    e32 = e.float().numpy()
    ab_t, ab_n = 0.6310, 0.6421
    want = np.asarray(jax_ddim_update(jnp.asarray(x), jnp.asarray(e32),
                                      jnp.float32(ab_t), jnp.float32(ab_n),
                                      jnp.float32(eta), interpret=True))
    out_of_place = fused_ddim_update(torch.tensor(x), e, ab_t, ab_n, eta)
    xt = torch.tensor(x)
    x0 = torch.full_like(xt, np.nan) if log_x0 else None
    before = fused_ddim_update.launches
    assert ddim_update_(xt, e, step_scalars(ab_t, ab_n, eta), x0) is xt
    assert fused_ddim_update.launches == before   # plain version ran
    np.testing.assert_allclose(xt.numpy(), want, atol=UPDATE_ATOL)
    np.testing.assert_array_equal(xt.numpy(), out_of_place.numpy())
    if log_x0:
        want_x0 = (x - np.sqrt(np.float32(1) - np.float32(ab_t)) * e32) \
            / np.sqrt(np.float32(ab_t))
        np.testing.assert_allclose(x0.numpy(), want_x0, atol=UPDATE_ATOL)
        np.testing.assert_array_equal(
            x0.numpy(), ddim_step_reference(
                torch.tensor(x), e, step_scalars(ab_t, ab_n, eta))[1].numpy())


def test_ddim_update_in_place_refuses_what_it_cannot_update():
    x = torch.zeros(2, 32, 16, 16)
    sc = step_scalars(0.5, 0.6, 0.0)
    with pytest.raises(ValueError, match="contiguous float32"):
        ddim_update_(x.bfloat16(), x, sc)
    with pytest.raises(ValueError, match="contiguous float32"):
        ddim_update_(x.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1), sc)
    with pytest.raises(ValueError, match="x0_out"):
        ddim_update_(x, x, sc, torch.zeros(2, 32, 16, 15))
    with pytest.raises(ValueError, match="differ"):
        ddim_update_(x, x[:1], sc)


@pytest.mark.parametrize("sampler", ["ddim", "dpm++"])
def test_samplers_leave_the_start_latent_untouched(pair, sampler):
    port = pair[2]
    z = torch.tensor(pair[4][:1]).permute(0, 3, 1, 2).contiguous()
    keep = z.clone()
    fn = ddim.ddim_sample if sampler == "ddim" else dpm_solver_pp_2m
    out = fn(lambda x, t: 0.1 * x, port.schedule, z,
             ddim.transfer_time_grid(6))
    assert torch.equal(z, keep)
    assert not torch.equal(out, keep)


@pytest.mark.parametrize("sampler,steps", [("ddim", None), ("dpm++", 7)])
def test_sampler_logs_match_jax(pair, sampler, steps):
    """return_logs stacks the per-step pred_x0 and noise_pred as the JAX
    samplers do; DDIM's pred_x0 is the update kernel's second output."""
    model, variables, port, styles, z_t = pair
    emb = _emb(model, variables, styles[:2])
    times = jddim.transfer_time_grid(14, steps)

    def jfn(x, t):
        return model.apply(variables, x, t, emb, method=JaxLDM.denoise)
    jsampler = jddim.ddim_sample if sampler == "ddim" else jdpm
    want, wlogs = jsampler(jfn, model.schedule, jnp.asarray(z_t[:2]),
                           times, return_logs=True)
    temb = {k: torch.tensor(np.asarray(v)).permute(0, 3, 1, 2)
            for k, v in emb.items()}
    tsampler = ddim.ddim_sample if sampler == "ddim" else dpm_solver_pp_2m
    with torch.no_grad():
        got, logs = tsampler(lambda x, t: port.unet(x, t, temb).float(),
                             port.schedule,
                             torch.tensor(z_t[:2]).permute(0, 3, 1, 2),
                             times, return_logs=True)
    assert set(logs) == set(wlogs) == {"timesteps", "pred_x0", "noise_pred"}
    np.testing.assert_array_equal(logs["timesteps"].numpy(),
                                  np.asarray(wlogs["timesteps"]))
    for k in ("pred_x0", "noise_pred"):
        assert tuple(logs[k].shape) == (len(times) - 1, 2, 32, 16, 16)
        np.testing.assert_allclose(logs[k].permute(0, 1, 3, 4, 2).numpy(),
                                   np.asarray(wlogs[k]), atol=LOG_ATOL)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=SCAN_ATOL)


@pytest.mark.parametrize("sampler,steps", [("ddim", None), ("dpm++", 7)])
def test_transfer_logs_match_jax(pair, sampler, steps):
    """content_style_transfer(return_logs=True) against the JAX package's,
    its per-item noise injected; the logs come back NHWC."""
    model, variables, port, styles, _ = pair
    content = np.random.RandomState(8).rand(2, 128, 128, 1).astype(
        np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want, want_zt, wlogs = jax_transfer(
        model, variables, keys, jnp.asarray(content),
        jnp.asarray(styles[:2]), num_timesteps=14, return_logs=True,
        sampler=sampler, steps=steps)
    z_0 = model.apply(variables, jnp.asarray(content), method=JaxLDM.encode)
    noise = np.asarray(jax.vmap(
        lambda k, z: jax.random.normal(k, z.shape, jnp.float32))(keys, z_0))
    plain = content_style_transfer(
        port, torch.tensor(content), torch.tensor(styles[:2]),
        num_timesteps=14, sampler=sampler, steps=steps,
        noise=torch.tensor(noise))
    got, got_zt, logs = content_style_transfer(
        port, torch.tensor(content), torch.tensor(styles[:2]),
        num_timesteps=14, sampler=sampler, steps=steps,
        noise=torch.tensor(noise), return_logs=True)
    assert len(plain) == 2 and torch.equal(plain[0], got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOG_ATOL)
    np.testing.assert_allclose(got_zt.numpy(), np.asarray(want_zt),
                               atol=LOG_ATOL)
    np.testing.assert_array_equal(logs["timesteps"].numpy(),
                                  np.asarray(wlogs["timesteps"]))
    for k in ("pred_x0", "noise_pred"):
        assert logs[k].shape == wlogs[k].shape
        np.testing.assert_allclose(logs[k].numpy(), np.asarray(wlogs[k]),
                                   atol=LOG_ATOL)


def test_guards(pair):
    _, _, port, styles, _ = pair
    s9 = torch.zeros(9, 128, 128, 1)
    with pytest.raises(ValueError, match="at most"):
        fs.fused_content_style_transfer(port, s9, s9, num_timesteps=10)
    with pytest.raises(ValueError, match="at most"):
        fs.pack_operands(port.unet, port.style_embed(s9[:1]), port.schedule,
                         ddim.transfer_time_grid(10), 0.0, batch=9)
    x = torch.tensor(styles[:1])
    with pytest.raises(ValueError, match="exceeds the schedule"):
        fs.fused_content_style_transfer(port, x, x, num_timesteps=250)
    with pytest.raises(ValueError, match="exceeds the schedule"):
        content_style_transfer(port, x, x, num_timesteps=250)
    with pytest.raises(ValueError, match="eta must be 0"):
        fs.fused_content_style_transfer(port, x, x, num_timesteps=10,
                                        eta=0.5, sampler="dpm++")
    with pytest.raises(ValueError, match="eta must be 0"):
        transfer_decoded(port, x, x, num_timesteps=10, eta=0.5,
                         sampler="dpm++")
    narrow = LDM(latent_dim=16).eval()
    with pytest.raises(ValueError, match="flagship UNet geometry"):
        fs.pack_operands(narrow.unet, narrow.style_embed(x), narrow.schedule,
                         ddim.transfer_time_grid(10), 0.0)


def test_trajectory_cost():
    """Work count at the flagship shapes: 51.5 M multiply-adds per
    element-step (47.2 M in the convs, 4.3 M in attention)."""
    port = LDM().eval()
    emb = port.style_embed(torch.zeros(1, 128, 128, 1))
    ops = fs.pack_operands(port.unet, emb, port.schedule,
                           ddim.transfer_time_grid(50), 0.0)
    cost = fs.trajectory_cost(ops, 1)
    assert cost["flops"] // 2 == 47_185_920 + 4_341_760
    assert cost["bytes"] > 4 * 6_000_000


# ---------------------------------------------------------------------------
# The kernel's packed layout and launch plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_unpack_gives_back_the_weights(pair, dtype):
    """Every conv and projection: pack_operands -> unpack is the module's
    weight and bias, exactly, in the working type."""
    port = pair[2]
    unet = {torch.float32: port.unet}.get(dtype)
    if unet is None:
        unet = LDM().eval().unet
        unet.load_state_dict(port.unet.state_dict())
        unet.to(dtype)
    emb = port.style_embed(torch.zeros(1, 128, 128, 1))
    ops = fs.pack_operands(unet, emb, port.schedule,
                           ddim.transfer_time_grid(10), 0.0)
    assert ops.weights.dtype == ops.biases.dtype == dtype
    got = fs.unpack(ops)
    assert list(got) == list(fs._NAMES)
    for name, path, *_ in fs._LAYERS:
        mod = unet.get_submodule(path)
        w, b = got[name]
        assert w.shape == mod.weight.shape, name
        assert torch.equal(w, mod.weight.to(dtype)), name
        assert torch.equal(b, mod.bias.to(dtype)), name


def test_weights_sit_in_mma_fragment_order(pair):
    """The packed A operand of mma.sync.m16n8k16, as PTX states it: lane
    4g + t, register r, half h of a tile's k-step s holds W[m][k] with m =
    g + 8 (r & 1), k = 16 s + 2 t + h + 8 (r >> 1)."""
    port = pair[2]
    emb = port.style_embed(torch.zeros(1, 128, 128, 1))
    ops = fs.pack_operands(port.unet, emb, port.schedule,
                           ddim.transfer_time_grid(10), 0.0)
    rng = np.random.RandomState(3)
    offset = 0
    for name, path, kind, cin, cout, *_ in fs._LAYERS:
        mat = fs._module_matrix(port.unet.get_submodule(path).weight, kind)
        k_total = mat.shape[1]
        assert k_total == (1 if kind == "p" else 9) * cin
        for _ in range(64):
            tile, s = rng.randint(cout // 16), rng.randint(k_total // 16)
            lane, r, h = rng.randint(32), rng.randint(4), rng.randint(2)
            g, t = divmod(lane, 4)
            m, k = g + 8 * (r & 1), 16 * s + 2 * t + h + 8 * (r >> 1)
            idx = (offset + tile * 16 * k_total
                   + ((s * 32 + lane) * 4 + r) * 2 + h)
            assert ops.weights[idx] == mat[tile * 16 + m, k], name
        offset += cout * k_total
    assert offset == ops.weights.numel()


@pytest.mark.parametrize("n_blocks", [132, 114])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_plan(n_blocks, dtype):
    """Every (layer, tile, replica) slot on exactly one block, never two
    slots of one layer on a block, bf16 tiles inside the opt-in shared
    memory of an H100 block, and every pass inside its scratch."""
    limit = 232448
    plan = fs.launch_plan(n_blocks, limit, dtype)
    assert len(plan["slots"]) == n_blocks
    seen = set()
    for slots, used in zip(plan["slots"], plan["weight_bytes"]):
        layers = [j for j, *_ in slots]
        assert len(layers) == len(set(layers))
        nbytes = 0
        for j, tile, rep, off in sorted(slots, key=lambda x: x[3]):
            _, _, kind, cin, *_ = fs._LAYERS[j]
            tile_bytes = (1 if kind == "p" else 9) * cin * 16 * 2
            if dtype == torch.bfloat16:
                assert off == nbytes and off % 512 == 0
                nbytes += tile_bytes
            seen.add((j, tile, rep))
        assert used == nbytes
    want = {(j, t, r) for j, (name, _, _, _, cout, *_) in
            enumerate(fs._LAYERS) for t in range(cout // 16)
            for r in range(fs._REPLICAS[name])}
    assert seen == want
    assert plan["smem_bytes"] + fs._STATIC_SMEM <= limit
    if dtype == torch.bfloat16:
        assert max(plan["weight_bytes"]) <= plan["scratch_off"]
        # all 12.3 MB of bf16 weights (and the replicas) stay on chip
        total = 2 * sum(w for w, _ in fs._layer_sizes())
        assert 12.2e6 < total < 12.4e6
        assert sum(plan["weight_bytes"]) >= total
    for j, g in enumerate(plan["groups"]):
        assert 1 <= g <= fs.FUSED_MAX_BATCH
        assert fs._fits(j, g, dtype)
        if g < fs.FUSED_MAX_BATCH:
            assert not fs._fits(j, g + 1, dtype)
    with pytest.raises(RuntimeError, match="do not fit"):
        fs.launch_plan(16, limit, torch.bfloat16)


def test_sum_order_does_not_depend_on_the_batch():
    """The k-split of each layer is fixed and divides its k-steps, every
    layer's maps fit their buffers, and the workspace holds every buffer
    of every element apart."""
    for name, _, kind, cin, *_ in fs._LAYERS:
        steps = (1 if kind == "p" else 9) * cin // 16
        assert steps % fs._KSPLIT[name] == 0, name
    per = dict(fs._BUFFERS)
    for _, _, _, cin, cout, hin, hout, src, dst, skip in fs._LAYERS:
        assert src == "x" or per[src] >= hin * hin * cin
        assert dst == "eps" or per[dst] >= hout * hout * cout
        assert skip is None or per[skip] == hout * hout * cout
    for batch in (1, 3, 8):
        ws = fs.workspace_layout(batch)
        ends = sorted((ws[name], ws[name] + batch * per)
                      for name, per in fs._BUFFERS)
        assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
        assert ends[-1][1] == ws["total"]
