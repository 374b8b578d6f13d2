"""The PyTorch port's models against the JAX package's, on the same weights.

The JAX LDM is initialised at random (f32), its variables go to numpy and
through ``interop.flax_weights.load_flax_variables`` into the port; both
sides then see the same numpy inputs.  BatchNorm running statistics are
randomised first so the eval-mode comparison is real.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.models import layers as jlayers
from music_style_transfer_ldm_tpu.models.ldm import LDM as JaxLDM
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_variables, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models import layers
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm

ATOL = 1e-5  # f32 on both sides; only summation order differs


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.RandomState(0)
    model = JaxLDM(dtype=jnp.float32)
    x = jnp.asarray(rng.rand(1, 128, 128, 1), jnp.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "diffusion": jax.random.PRNGKey(1)},
                           x, x, jnp.zeros((1,), jnp.int32))
    variables = jax.tree_util.tree_map(np.array, variables)
    for comp in ("encoder", "decoder"):
        for bn in variables["batch_stats"][comp].values():
            n = bn["mean"].shape[0]
            bn["mean"] = (0.1 * rng.randn(n)).astype(np.float32)
            bn["var"] = (0.5 + rng.rand(n)).astype(np.float32)
    port = build_ldm(device="cpu")
    load_flax_variables(port, variables)
    return model, variables, port


def flax_parameter_count(tree):
    return sum(int(np.size(v)) for v in jax.tree_util.tree_leaves(tree))


def count_parameters(module):
    return sum(p.numel() for p in module.parameters())


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


def test_parameter_counts(pair):
    _, variables, port = pair
    params = variables["params"]
    want = {"encoder": 111_840, "decoder": 198_209,
            "style_encoder": 2_729_984}
    for comp, n in want.items():
        assert flax_parameter_count(params[comp]) == n
        assert count_parameters(getattr(port, comp)) == n
    assert (count_parameters(port.unet)
            == flax_parameter_count(params["unet"]))
    assert count_parameters(port) == flax_parameter_count(params)


def test_converter_round_trip(pair):
    _, variables, port = pair
    back = export_flax_variables(port)
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_in) == len(flat_out)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_out[path], leaf)


def _conv_pair(kind, rng):
    cin, cout = 6, 5
    if kind == "s1":
        fl, tm = jlayers.conv_s1(cout), layers.conv_s1(cin, cout)
    elif kind == "s2":
        fl, tm = jlayers.conv_s2(cout), layers.conv_s2(cin, cout)
    elif kind == "k3":
        fl, tm = jlayers.convT_k3(cout), layers.convT_k3(cin, cout)
    else:
        fl, tm = jlayers.convT_k4(cout), layers.convT_k4(cin, cout)
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray,
                               fl.init(jax.random.PRNGKey(3), x)["params"])
    want = fl.apply({"params": p}, x)
    if kind == "k3":
        want = jlayers.crop_k3_output(want)
    k = p["kernel"]
    if kind in ("k3", "k4"):
        w = k[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
        w = k.transpose(3, 2, 0, 1)
    with torch.no_grad():
        tm.weight.copy_(torch.tensor(np.ascontiguousarray(w)))
        tm.bias.copy_(torch.tensor(p["bias"]))
        got = tm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return got, want


@pytest.mark.parametrize("kind", ["s1", "s2", "k3", "k4"])
def test_conv_geometries(kind):
    got, want = _conv_pair(kind, np.random.RandomState(1))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_sinusoidal_embedding():
    t = np.asarray([0, 1, 57, 199], np.int32)
    want = jlayers.SinusoidalPositionEmbeddings(128).apply({}, jnp.asarray(t))
    _close(layers.sinusoidal_embedding(torch.tensor(t), 128), want)


def test_cross_attention():
    rng = np.random.RandomState(2)
    E = 64
    fl = jlayers.CrossAttention(embed_dim=E, num_heads=4)
    q = rng.randn(2, 4, 4, E).astype(np.float32)
    s = rng.randn(2, 2, 2, E).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray,
                               fl.init(jax.random.PRNGKey(4), q, s)["params"])
    want = fl.apply({"params": p}, q, s)
    tm = layers.CrossAttention(E, 4)
    with torch.no_grad():
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            getattr(tm, name).weight.copy_(torch.tensor(p[name]["kernel"].T))
            getattr(tm, name).bias.copy_(torch.tensor(p[name]["bias"]))
        got = tm(torch.tensor(q).permute(0, 3, 1, 2),
                 torch.tensor(s).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got, want)


def test_autoencoder_eval(pair):
    model, variables, port = pair
    x = np.random.RandomState(3).rand(2, 128, 128, 1).astype(np.float32)
    z = model.apply(variables, jnp.asarray(x), method=JaxLDM.encode)
    with torch.no_grad():
        z_port = port.encode(torch.tensor(x))
        _close(z_port, z)
        d = model.apply(variables, z, method=JaxLDM.decode)
        _close(port.decode(torch.tensor(np.asarray(z))), d)


def test_style_pyramid(pair):
    model, variables, port = pair
    s = np.random.RandomState(4).rand(2, 128, 128, 1).astype(np.float32)
    want = model.apply(variables, jnp.asarray(s), method=JaxLDM.style_embed)
    with torch.no_grad():
        got = port.style_embed(torch.tensor(s))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape)
        _close(got[k], want[k])


def test_unet_three_timesteps(pair):
    model, variables, port = pair
    rng = np.random.RandomState(5)
    s = rng.rand(3, 128, 128, 1).astype(np.float32)
    z = rng.randn(3, 16, 16, 32).astype(np.float32)
    t = np.asarray([0, 57, 199], np.int32)
    emb = model.apply(variables, jnp.asarray(s), method=JaxLDM.style_embed)
    want = model.apply(variables, jnp.asarray(z), jnp.asarray(t), emb,
                       method=JaxLDM.denoise)
    with torch.no_grad():
        got = port.denoise(torch.tensor(z), torch.tensor(t),
                           {k: torch.tensor(np.asarray(v))
                            for k, v in emb.items()})
    _close(got, want)
