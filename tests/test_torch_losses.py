"""The port's losses against the JAX package's, on the same weights and
inputs (f32, CPU; Pallas kernels in interpret mode).

Kernel D's wrapper and kernel E's wrapper run their plain versions here
(the tensors lie on the CPU), so every wrapper is checked against the
Pallas kernel it replaces, and the plain versions against the JAX
package's closed-form (XLA) path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.losses import basic as jbasic
from music_style_transfer_ldm_tpu.losses.lpips import LPIPS as JaxLPIPS
from music_style_transfer_ldm_tpu.losses.lpips import (
    convert_torch_lpips_state_dict as jax_convert_lpips,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    VGGishFeatures as JaxVGGish,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    convert_torchvggish_state_dict as jax_convert_vggish,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    normalized_mse as jax_normalized_mse,
)
from music_style_transfer_ldm_tpu.losses.vggish import (
    vggish_feature_distance as jax_vggish_distance,
)
from music_style_transfer_ldm_tpu.ops.pallas.fused_trunk import (
    _conv1_both as jax_conv1_both,
)
from music_style_transfer_ldm_tpu.ops.pallas.fused_trunk import (
    _trunk_call as jax_trunk_call,
)
from music_style_transfer_ldm_tpu.ops.pallas.fused_trunk import (
    fused_vggish_distance as jax_fused_distance,
)
from music_style_transfer_ldm_tpu.ops.pallas.normalized_mse import (
    normalized_mse_pallas,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs, load_flax_convs,
)
from music_style_transfer_ldm_tpu_torch.losses import basic
from music_style_transfer_ldm_tpu_torch.losses.feature import (
    build_feature_metric,
)
from music_style_transfer_ldm_tpu_torch.losses.lpips import (
    LPIPS, convert_torch_lpips_state_dict,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import (
    VGGishFeatures, convert_torchvggish_state_dict, normalized_mse,
    resolve_impl, vggish_feature_distance,
)
from music_style_transfer_ldm_tpu_torch.ops import fused_trunk as ft
from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm

RTOL_VALUE = 1e-5          # f32 both sides; only summation order differs
# The JAX suite's (tests/test_losses.py:212-214): dp, dt to 1e-7; dw,
# a difference of nearly equal terms, to 1e-6.
RTOL_GRAD, ATOL_GRAD, ATOL_DW = 1e-4, 1e-7, 1e-6
GRAD_OF_MAX = 1e-4         # max abs error / max |grad| (test_fused_trunk)
SMALL_WIDTHS = (8, 16, 32, 32, 64, 64)
NAMES = ("conv1", "conv2", "conv3_1", "conv3_2", "conv4_1", "conv4_2")


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


# ---------------- kernel D ---------------------------------------------------


@functools.lru_cache(maxsize=1)
def _nm_case():
    rng = np.random.RandomState(0)
    p = rng.randn(3, 16, 16, 64).astype(np.float32)
    t = rng.randn(3, 16, 16, 64).astype(np.float32)
    w = np.asarray([1.0, 1.0, 0.0], np.float32)
    fn = lambda a, b, c: normalized_mse_pallas(a, b, c, True)  # noqa: E731
    want = {}
    for name, f in (("xla", jax_normalized_mse), ("pallas", fn)):
        v, g = jax.value_and_grad(f, argnums=(0, 1, 2))(p, t, w)
        want[name] = (float(v), [np.asarray(x) for x in g])
    return p, t, w, want


@pytest.mark.parametrize("port", ["plain", "kernel_wrapper"])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_normalized_mse_value_and_grads(port, ref):
    p, t, w, want = _nm_case()
    fn = normalized_mse if port == "plain" else nm.normalized_mse_kernel
    P, T, W = _t(p, True), _t(t, True), _t(w, True)
    loss = fn(P, T, W)
    loss.backward()
    v, grads = want[ref]
    np.testing.assert_allclose(loss.item(), v, rtol=RTOL_VALUE)
    for got, g, atol in zip((P.grad, T.grad, W.grad), grads,
                            (ATOL_GRAD, ATOL_GRAD, ATOL_DW)):
        np.testing.assert_allclose(got.numpy(), g, rtol=RTOL_GRAD, atol=atol)


def test_normalized_mse_pieces():
    """Forward stats and the backward's options (gin, ReLU mask, output
    dtype) against their definitions."""
    rng = np.random.RandomState(1)
    p = torch.relu(torch.tensor(rng.randn(2, 4, 4, 8), dtype=torch.float32))
    t = torch.tensor(rng.randn(2, 4, 4, 8), dtype=torch.float32)
    m, stats = nm.normalized_mse_forward(p, t)
    p64, t64 = p.double().reshape(2, -1), t.double().reshape(2, -1)
    sp, st = p64.std(1, unbiased=False), t64.std(1, unbiased=False)
    d = p64 / (sp[:, None] + 1e-8) - t64 / (st[:, None] + 1e-8)
    np.testing.assert_allclose(m.numpy(), (d * d).mean(1).numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(
        stats.numpy(), torch.stack([p64.mean(1), sp, t64.mean(1), st],
                                   1).numpy(), rtol=1e-5, atol=1e-7)
    us = torch.tensor([0.5, 2.0])
    gin = torch.tensor(rng.randn(2, 4, 4, 8), dtype=torch.float32)
    plain = nm.normalized_mse_backward(p, t, stats, us, False)
    full = nm.normalized_mse_backward(p, t, stats, us, False, gin=gin,
                                      mask=True, out_dtype=torch.float32)
    np.testing.assert_array_equal(
        full.numpy(), torch.where(p > 0, gin + plain, 0.0).numpy())
    half = nm.normalized_mse_backward(p.bfloat16(), t.bfloat16(), stats, us,
                                      True)
    assert half.dtype == torch.bfloat16 and half.shape == t.shape


def test_normalized_mse_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        nm.normalized_mse_forward(x, x)
    with pytest.raises(RuntimeError, match="no kernel"):
        nm.normalized_mse_backward(x, x, torch.zeros(2, 4), torch.ones(2),
                                   False)
    f1 = torch.zeros(4, 16, 16, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ft.fused_trunk(VGGishFeatures(widths=SMALL_WIDTHS), f1)


# ---------------- kernel E ---------------------------------------------------


@functools.lru_cache(maxsize=1)
def small_params():
    """The small trunk of tests/test_fused_trunk.py."""
    key = jax.random.PRNGKey(0)
    params, cin = {}, 1
    for name, cout in zip(NAMES, SMALL_WIDTHS):
        key, k1, k2 = jax.random.split(key, 3)
        params[name] = {
            "kernel": np.asarray(jax.random.normal(
                k1, (3, 3, cin, cout), jnp.float32) * 0.2),
            "bias": np.asarray(jax.random.normal(
                k2, (cout,), jnp.float32) * 0.05)}
        cin = cout
    return params


def small_module():
    mod = VGGishFeatures(widths=SMALL_WIDTHS)
    load_flax_convs(mod, small_params())
    return mod


def make_inputs(H, W, B=3, seed=7):
    kp, kt = jax.random.split(jax.random.PRNGKey(seed))
    pred = np.asarray(jax.random.uniform(kp, (B, H, W, 1), jnp.float32))
    target = np.asarray(jax.random.uniform(kt, (B, H, W, 1), jnp.float32))
    weights = np.asarray([1.0] * (B - 1) + [0.0], np.float32)
    return pred, target, weights


@functools.lru_cache(maxsize=4)
def _fused_reference(H, W):
    params = small_params()
    pred, target, weights = make_inputs(H, W)
    f = lambda p: jax_fused_distance(  # noqa: E731
        params, p, target, weights, jnp.float32, True)
    v, g = jax.value_and_grad(f)(pred)
    return float(v), np.asarray(g)


@pytest.mark.parametrize("impl", ["plain", "layer", "fused", "fused-value"])
@pytest.mark.parametrize("H,W", [(16, 16), (24, 16)])
def test_vggish_impls_match_the_pallas_trunk(H, W, impl):
    want_v, want_g = _fused_reference(H, W)
    pred, target, weights = make_inputs(H, W)
    P = _t(pred, True)
    got = vggish_feature_distance(small_module(), P, _t(target),
                                  _t(weights), impl=impl)
    np.testing.assert_allclose(got.item(), want_v, rtol=RTOL_VALUE)
    if impl == "fused-value":
        assert not got.requires_grad
        return
    got.backward()
    g = P.grad.numpy()
    assert np.abs(g - want_g).max() / np.abs(want_g).max() < GRAD_OF_MAX
    np.testing.assert_array_equal(g[-1], 0.0)   # zero-weight sample


def test_trunk_plain_version_matches_the_pallas_kernel():
    """fused_trunk (its plain version on the CPU) against _trunk_call in
    interpret mode on the same f1: the six metrics and g1."""
    params = small_params()
    pred, target, _ = make_inputs(16, 16)
    f1 = np.asarray(jax_conv1_both(params, pred, target, jnp.float32))
    m_want, g1_want = jax_trunk_call(params, f1, 16, 16, interpret=True)
    m_want, g1_want = np.asarray(m_want), np.asarray(g1_want)
    mod = small_module()
    f1_port = ft.conv1_both(mod, _t(pred), _t(target))
    B, C1 = pred.shape[0], SMALL_WIDTHS[0]
    both = np.concatenate([f1[..., :C1], f1[..., C1:]]).reshape(
        2 * B, 16, 16, C1)
    np.testing.assert_allclose(f1_port.numpy(), both, rtol=1e-6, atol=1e-6)
    m, g1 = ft.fused_trunk(mod, f1_port, with_grad=True)
    np.testing.assert_allclose(m.numpy(), m_want, rtol=RTOL_VALUE)
    g1_want = g1_want.reshape(B, 16, 16, C1)
    assert (np.abs(g1.numpy() - g1_want).max() / np.abs(g1_want).max()
            < GRAD_OF_MAX)
    m_value, none = ft.fused_trunk(mod, f1_port, with_grad=False)
    assert none is None
    np.testing.assert_array_equal(m_value.numpy(), m.numpy())


def test_fused_weights_grad_and_zero_target_grad():
    mod = small_module()
    pred, target, weights = make_inputs(16, 16)
    params = small_params()
    wref = jax.grad(lambda w: jax_fused_distance(
        params, pred, target, w, jnp.float32, True))(weights)
    P, T, Wt = _t(pred, True), _t(target, True), _t(weights, True)
    ft.fused_vggish_distance(mod, P, T, Wt).backward()
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(wref),
                               rtol=RTOL_GRAD, atol=ATOL_DW)
    np.testing.assert_array_equal(T.grad.numpy(), 0.0)   # by design
    assert not any(p.requires_grad for p in mod.parameters())


def test_fused_reference_and_geometry_guard():
    mod = small_module()
    pred, target, weights = make_inputs(16, 16)
    ref = ft.fused_vggish_distance_reference(mod, _t(pred), _t(target),
                                             _t(weights))
    np.testing.assert_allclose(ref.item(), _fused_reference(16, 16)[0],
                               rtol=RTOL_VALUE)
    with pytest.raises(ValueError, match="divisible by 8"):
        ft.fused_vggish_distance(mod, _t(pred[:, :12]), _t(target[:, :12]),
                                 _t(weights))


# XLA's CPU sum of 2^18 f32 values (a 64x64x64 layer-1 sample) is less
# accurate than the port's pairwise sums (checked against float64), so
# at 64x64 the JAX side is the looser one: the value is held to 1e-4 and
# the gradients to 1e-3 of their max.  At 16x16 the sums are short and
# the tight bars hold.
FULL_WIDTH_TOL = {16: (RTOL_VALUE, GRAD_OF_MAX), 64: (1e-4, 1e-3)}


@functools.lru_cache(maxsize=2)
def _full_width_case(size=64):
    """The real VGGish widths at size x size, B=2: the JAX xla path's
    value and pred/target gradients."""
    module = JaxVGGish(dtype=jnp.float32)
    torch.manual_seed(3)
    params = export_flax_convs(VGGishFeatures())   # flax's default init
    pred, target, weights = make_inputs(size, size, B=2)
    f = lambda p, t: jax_vggish_distance(  # noqa: E731
        module, params, p, t, weights, impl="xla")
    v, (gp, gt) = jax.value_and_grad(f, argnums=(0, 1))(pred, target)
    return params, (pred, target, weights), float(v), np.asarray(gp), \
        np.asarray(gt)


@pytest.mark.parametrize("size", [16, 64])
@pytest.mark.parametrize("impl", ["plain", "layer", "fused"])
def test_full_width_trunk_matches_the_xla_path(impl, size):
    rtol, grad_tol = FULL_WIDTH_TOL[size]
    params, (pred, target, weights), v, gp, gt = _full_width_case(size)
    mod = VGGishFeatures()
    load_flax_convs(mod, params)
    assert ft.fused_supported(mod, _t(pred))
    P, T = _t(pred, True), _t(target, True)
    got = vggish_feature_distance(mod, P, T, _t(weights), impl=impl)
    got.backward()
    np.testing.assert_allclose(got.item(), v, rtol=rtol)
    assert np.abs(P.grad.numpy() - gp).max() / np.abs(gp).max() < grad_tol
    if impl == "fused":
        np.testing.assert_array_equal(T.grad.numpy(), 0.0)
    else:
        assert np.abs(T.grad.numpy() - gt).max() / np.abs(gt).max() < grad_tol


def test_auto_sends_target_gradients_to_the_layer_route():
    """On the card, auto takes the fused kernel only when target needs no
    gradient: the compression term's VGGish distance differentiates its
    target (the reconstruction)."""
    mod = VGGishFeatures()
    x = torch.zeros(2, 64, 64, 1, device="meta")
    xg = x.clone().requires_grad_(True)
    assert resolve_impl(mod, x, xg) == "layer"
    assert resolve_impl(mod, xg, x) == "fused"
    assert resolve_impl(mod, xg, xg) == "layer"
    assert resolve_impl(mod, x, x) == "fused-value"
    with torch.no_grad():
        assert resolve_impl(mod, xg, xg) == "fused-value"
    odd = torch.zeros(2, 60, 64, 1, device="meta", requires_grad=True)
    assert resolve_impl(mod, odd, x) == "layer"
    assert resolve_impl(mod, torch.zeros(1, 8, 8, 1), x) == "plain"
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl(mod, x, x, "xla")


@pytest.mark.parametrize("impl", ["auto", "layer"])
def test_compression_term_trains_through_its_target(impl):
    """compression_loss(original, reconstructed, ...) puts the
    reconstruction in the feature loss's target slot; its VGGish gradient
    must not vanish."""
    params, (pred, target, _), _, _, gt = _full_width_case()
    mod = VGGishFeatures()
    load_flax_convs(mod, params)
    recon = _t(target, True)
    feature = lambda a, b, w: vggish_feature_distance(  # noqa: E731
        mod, a, b, w, impl=impl)
    loss = basic.compression_loss(_t(pred), recon, torch.zeros(2, 8, 8, 4),
                                  feature, perceptual_weight=1.0,
                                  kl_weight=0.0)
    loss.backward()
    mse_grad = 2.0 * (target - pred) / target.size
    feat_grad = recon.grad.numpy() - mse_grad
    assert np.abs(feat_grad).max() > 0.1 * np.abs(gt).max()
    # the fused kernel would have given the target nothing
    recon2 = _t(target, True)
    ft.fused_vggish_distance(mod, _t(pred), recon2,
                             torch.ones(2)).backward()
    np.testing.assert_array_equal(recon2.grad.numpy(), 0.0)


# ---------------- LPIPS, basic losses, converters ----------------------------


@functools.lru_cache(maxsize=1)
def _lpips_case():
    rng = np.random.RandomState(5)
    a = rng.rand(2, 64, 64, 1).astype(np.float32)
    b = rng.rand(2, 64, 64, 1).astype(np.float32)
    w = np.asarray([1.0, 0.5], np.float32)
    module = JaxLPIPS(dtype=jnp.float32)
    torch.manual_seed(2)
    params = export_flax_convs(LPIPS())   # flax's default init
    f = lambda x, y: module.apply({"params": params}, x, y, w)  # noqa: E731
    v, (ga, gb) = jax.value_and_grad(f, argnums=(0, 1))(a, b)
    return params, (a, b, w), float(v), np.asarray(ga), np.asarray(gb)


def test_lpips_value_and_grads():
    params, (a, b, w), v, ga, gb = _lpips_case()
    mod = LPIPS()
    load_flax_convs(mod, params)
    A, Bt = _t(a, True), _t(b, True)
    got = mod(A, Bt, _t(w))
    got.backward()
    np.testing.assert_allclose(got.item(), v, rtol=RTOL_VALUE)
    for g, want in ((A.grad, ga), (Bt.grad, gb)):
        assert (np.abs(g.numpy() - want).max() / np.abs(want).max()
                < GRAD_OF_MAX)


def test_feature_converters_round_trip_and_torch_state_dicts():
    params = _lpips_case()[0]
    mod = LPIPS()
    load_flax_convs(mod, params)
    back = export_flax_convs(mod)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(flat[path], leaf)
    rng = np.random.RandomState(9)
    # torch lpips layout -> both packages
    sd = {}
    for key, cin, cout, k in (("net.slice1.0", 3, 64, 11),
                              ("net.slice2.3", 64, 192, 5),
                              ("net.slice3.6", 192, 384, 3),
                              ("net.slice4.8", 384, 256, 3),
                              ("net.slice5.10", 256, 256, 3)):
        sd[f"{key}.weight"] = rng.randn(cout, cin, k, k).astype(np.float32)
        sd[f"{key}.bias"] = rng.randn(cout).astype(np.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = rng.rand(1, c, 1, 1).astype(
            np.float32)
    ported = LPIPS()
    ported.load_state_dict(convert_torch_lpips_state_dict(sd))
    via_jax = LPIPS()
    load_flax_convs(via_jax, jax.tree_util.tree_map(
        np.asarray, jax_convert_lpips(sd)))
    for (k, x), (_, y) in zip(ported.state_dict().items(),
                              via_jax.state_dict().items()):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=k)
    vsd = {}
    for idx, (cin, cout) in zip((0, 3, 6, 8, 11, 13),
                                ((1, 64), (64, 128), (128, 256), (256, 256),
                                 (256, 512), (512, 512))):
        vsd[f"features.{idx}.weight"] = rng.randn(cout, cin, 3, 3).astype(
            np.float32)
        vsd[f"features.{idx}.bias"] = rng.randn(cout).astype(np.float32)
    v1, v2 = VGGishFeatures(), VGGishFeatures()
    v1.load_state_dict(convert_torchvggish_state_dict(vsd))
    load_flax_convs(v2, jax.tree_util.tree_map(np.asarray,
                                               jax_convert_vggish(vsd)))
    for (k, x), (_, y) in zip(v1.state_dict().items(),
                              v2.state_dict().items()):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_basic_losses(weighted):
    rng = np.random.RandomState(11)
    x = rng.rand(3, 8, 8, 1).astype(np.float32)
    r = rng.rand(3, 8, 8, 1).astype(np.float32)
    z = rng.randn(3, 4, 4, 8).astype(np.float32)
    w = np.asarray([1.0, 0.0, 1.0], np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    feat = lambda a, b, ww: basic.mse(a * 2.0, b, ww)  # noqa: E731
    jfeat = lambda a, b, ww: jbasic.mse(a * 2.0, b, ww)  # noqa: E731
    pairs = [
        (basic.weighted_batch_mean(_t(z), tw),
         jbasic.weighted_batch_mean(z, jw)),
        (basic.mse(_t(x), _t(r), tw), jbasic.mse(x, r, jw)),
        (basic.kl_regularization_loss(_t(z), tw),
         jbasic.kl_regularization_loss(z, jw)),
        (basic.diffusion_loss(_t(z), _t(z[::-1].copy()), tw),
         jbasic.diffusion_loss(z, z[::-1], jw)),
        (basic.compression_loss(_t(x), _t(r), _t(z), feat, weights=tw),
         jbasic.compression_loss(x, r, z, jfeat, weights=jw)),
        (basic.compression_loss(_t(x), _t(r), _t(z), None, weights=tw),
         jbasic.compression_loss(x, r, z, None, weights=jw)),
        (basic.style_loss(_t(r), _t(x), feat, tw),
         jbasic.style_loss(r, x, jfeat, jw)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=RTOL_VALUE)


def test_build_feature_metric_is_seeded():
    a = build_feature_metric("vggish", seed=3, device="cpu")
    b = build_feature_metric("vggish", seed=3, device="cpu")
    c = build_feature_metric("lpips", seed=3, device="cpu")
    for (k, x), (_, y) in zip(a.module.state_dict().items(),
                              b.module.state_dict().items()):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=k)
    assert c.kind == "lpips" and isinstance(c.module, LPIPS)
    # lecun-normal scale of flax's default init
    w = a.module.conv4_2.weight
    assert abs(w.std().item() - (1.0 / (9 * 512)) ** 0.5) < 2e-3
    with pytest.raises(ValueError, match="unknown feature extractor"):
        build_feature_metric("vgg", device="cpu")


def test_build_feature_metric_defaults_to_the_card():
    """Like every entry point of the port, the metric goes to the card
    unless the caller asks for the CPU: without a card it raises."""
    if torch.cuda.is_available():
        assert next(build_feature_metric("vggish").module.parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_feature_metric("vggish")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_feature_metric("lpips", device="cuda")
