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
    ddim_update_reference, fused_ddim_update,
)

SCAN_ATOL = 1e-4    # latents after a scan trajectory (f32, sum order)
FUSED_ATOL = 1e-5   # fused plain version vs JAX packed executor, DDIM
DPM_ATOL = 1e-4     # ... DPM++(2M), as tests/test_fused_sampler.py uses
UPDATE_ATOL = 1e-6  # one elementwise DDIM step, f32


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


@pytest.mark.parametrize("batch,sampler,n,steps,atol", [
    (1, "ddim", 12, None, FUSED_ATOL),
    (4, "ddim", 12, None, FUSED_ATOL),
    (1, "dpm++", 14, 7, DPM_ATOL),
    (4, "dpm++", 14, 7, DPM_ATOL)])
def test_fused_plain_version_matches_jax(pair, batch, sampler, n, steps,
                                         atol):
    model, variables, port, styles, z_t = pair
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


def test_fused_eta_matches_scan(pair):
    """eta > 0 folds into the same A/B update as the scan DDIM step."""
    _, _, port, styles, z_t = pair
    emb = port.style_embed(torch.tensor(styles[:2]))
    times = ddim.transfer_time_grid(10)
    ops = fs.pack_operands(port.unet, emb, port.schedule, times, 0.5,
                           batch=2)
    got = fs.fused_ddim_sample(ops, torch.tensor(z_t[:2]), len(times) - 1)
    temb = {k: v.permute(0, 3, 1, 2) for k, v in emb.items()}
    with torch.no_grad():
        want = ddim.ddim_sample(lambda x, t: port.unet(x, t, temb).float(),
                                port.schedule,
                                torch.tensor(z_t[:2]).permute(0, 3, 1, 2),
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
