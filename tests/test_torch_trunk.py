"""Kernels E and D's host-side pieces on the CPU: the trunk convs' weight
packing and tap geometry against the JAX trunk, the bf16 kernel's limits,
and kernel D's six-column statistics and its single-pass reduction (a
float32 model of csrc/normalized_mse.cu's order) against float64.

The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.ops.pallas.fused_trunk import (
    _conv_bwd_input as jax_conv_bwd_input,
)
from music_style_transfer_ldm_tpu.ops.pallas.fused_trunk import (
    _conv_fwd as jax_conv_fwd,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    export_flax_convs,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import (
    VGGishFeatures, resolve_impl,
)
from music_style_transfer_ldm_tpu_torch.ops import fused_trunk as ft
from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm

NAMES = ("conv1", "conv2", "conv3_1", "conv3_2", "conv4_1", "conv4_2")
RTOL_F32 = 1e-5       # f32 sums in another order than the JAX trunk's
RTOL_MOMENTS = 1e-6   # the single-pass model against float64


# ---------------- kernel E: packing, tap geometry, limits ---------------------


@pytest.fixture(scope="module")
def vggish():
    torch.manual_seed(3)
    mod = VGGishFeatures()
    return mod, export_flax_convs(mod)


@pytest.mark.parametrize("name", NAMES[1:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weight_packing_round_trips(vggish, name, dtype):
    """forward_weights and dgrad_weights at the full VGGish widths: the
    JAX trunk's w9 = kernel.reshape(9, Cin, Cout), K-major for the bf16
    forward, and back to conv.weight."""
    mod, flax = vggish
    conv = getattr(mod, name)
    cin, cout = conv.in_channels, conv.out_channels
    w9 = torch.tensor(flax[name]["kernel"]).reshape(9, cin, cout).to(dtype)
    fwd, dg = ft.forward_weights(conv, dtype), ft.dgrad_weights(conv, dtype)
    assert fwd.is_contiguous() and dg.is_contiguous()
    assert fwd.dtype == dg.dtype == dtype
    torch.testing.assert_close(dg, w9, rtol=0, atol=0)
    if dtype == torch.bfloat16:
        assert fwd.shape == (9, cout, cin)
        back = fwd.reshape(3, 3, cout, cin).permute(2, 3, 0, 1)
    else:
        assert fwd.shape == (9, cin, cout)
        back = fwd.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    torch.testing.assert_close(back, conv.weight.detach().to(dtype),
                               rtol=0, atol=0)
    back_dg = dg.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)
    torch.testing.assert_close(back_dg, conv.weight.detach().to(dtype),
                               rtol=0, atol=0)


def _tc_model(act, w, bias, dgrad):
    """The bf16 kernel's implicit GEMM in plain torch (f32): tap t = 3 ky
    + kx at (dy, dx) = (ky - 1, kx - 1), the source pixel (y + dy, x + dx)
    forward and (y - dy, x - dx) for the input gradient, zero outside the
    map (TMA's fill); w is [9, N, K] (K-major).  act [n, H, W, K]."""
    n, H, W, _ = act.shape
    pad = torch.nn.functional.pad(act, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n, H, W, w.shape[1])
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        if dgrad:
            dy, dx = -dy, -dx
        src = pad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        acc += src @ w[tap].T
    return acc if bias is None else acc + bias


@pytest.mark.parametrize("name", ["conv2", "conv3_2"])
def test_tap_geometry_matches_the_jax_trunk(vggish, name):
    """The bf16 kernel's indexing on the packed weights (forward and
    input gradient) against the JAX trunk's _conv_fwd / _conv_bwd_input
    on the same operands, in f32."""
    mod, flax = vggish
    conv = getattr(mod, name)
    cin, cout = conv.in_channels, conv.out_channels
    H, W = 8, 16
    rng = np.random.RandomState(0)
    x = rng.randn(2, H, W, cin).astype(np.float32)
    g = rng.randn(2, H, W, cout).astype(np.float32)
    w9 = flax[name]["kernel"].reshape(9, cin, cout)
    want_y = np.asarray(jax_conv_fwd(x.reshape(-1, cin), w9, H, W,
                                     jnp.float32))
    want_dx = np.asarray(jax_conv_bwd_input(g.reshape(-1, cout), w9, H, W,
                                            jnp.float32))
    fwd = w9.transpose(0, 2, 1)   # what forward_weights gives in bf16
    torch.testing.assert_close(ft.forward_weights(conv, torch.bfloat16),
                               torch.tensor(fwd).bfloat16(), rtol=0, atol=0)
    y = _tc_model(torch.tensor(x), torch.tensor(fwd), None, False)
    dx = _tc_model(torch.tensor(g), ft.dgrad_weights(conv, torch.float32),
                   None, True)
    np.testing.assert_allclose(y.reshape(-1, cout).numpy(), want_y,
                               rtol=RTOL_F32, atol=1e-5)
    np.testing.assert_allclose(dx.reshape(-1, cin).numpy(), want_dx,
                               rtol=RTOL_F32, atol=1e-5)
    # and the forward epilogue's rounding points are conv_relu's
    bias = conv.bias.detach().float()
    pre = _tc_model(torch.tensor(x).bfloat16().float(),
                    torch.tensor(fwd).bfloat16().float(), bias, False)
    with torch.no_grad():
        want = ft.conv_relu(torch.tensor(x).permute(0, 3, 1, 2), conv,
                            torch.bfloat16).permute(0, 2, 3, 1)
    got = torch.relu(pre.to(torch.bfloat16))
    # one bf16 ulp, taken no lower than at 2^-16 of the map's max (below
    # it the f32 sums' order decides, as on the card)
    diff = (got.float() - want.float()).abs()
    top = torch.maximum(want.float().abs(), got.float().abs())
    ulp = top.clamp_min(2.0 ** -16 * want.float().abs().max()) * 2.0 ** -7
    assert bool((diff <= ulp).all())


@pytest.mark.parametrize("size,dtype,ok", [
    ((128, 128), torch.bfloat16, True),     # the training images
    ((128, 256), torch.bfloat16, True),
    ((64, 128), torch.bfloat16, True),      # conv4 at 8 x 16
    ((64, 64), torch.bfloat16, False),      # conv4 at 8 x 8: W % 16
    ((96, 128), torch.bfloat16, False),     # conv4 at 12 x 16: H % 8
    ((64, 64), torch.float32, True),        # the f32 kernel: H, W % 8
    ((24, 16), torch.float32, True),
    ((20, 16), torch.float32, False),
])
def test_fused_supported_bf16_limits(size, dtype, ok):
    mod = VGGishFeatures(dtype)
    x = torch.zeros(2, *size, 1, device="meta")
    assert ft.fused_supported(mod, x) is ok
    assert ft.tc_fits(mod, *size) is (size[0] % 64 == 0
                                      and size[1] % 128 == 0)
    route = resolve_impl(mod, x, x)
    assert route == ("fused-value" if ok else "layer")


def test_bf16_limits_need_64_channel_widths():
    narrow = VGGishFeatures(torch.bfloat16, widths=(8, 16, 32, 32, 64, 64))
    x = torch.zeros(2, 128, 128, 1, device="meta")
    assert not ft.fused_supported(narrow, x)
    assert ft.fused_supported(VGGishFeatures(widths=(8, 16, 32, 32, 64, 64)),
                              x)


# ---------------- kernel D: statistics and the single-pass model -------------


def _oracle(p, t):
    """float64 two-pass statistics: m and (mu_p, s_p, mu_t, s_t, a0, b0),
    and the magnitude sums that bound a0's and b0's rounding."""
    p64, t64 = p.double().reshape(p.shape[0], -1), t.double().reshape(
        t.shape[0], -1)
    mu_p, mu_t = p64.mean(1), t64.mean(1)
    s_p = ((p64 - mu_p[:, None]) ** 2).mean(1).sqrt()
    s_t = ((t64 - mu_t[:, None]) ** 2).mean(1).sqrt()
    A, B = (s_p + nm.EPS)[:, None], (s_t + nm.EPS)[:, None]
    d = p64 / A - t64 / B
    mag = p64.abs() / A + t64.abs() / B
    stats = torch.stack([mu_p, s_p, mu_t, s_t, (p64 * d).sum(1),
                         (t64 * d).sum(1)], 1)
    scale = torch.stack([(p64.abs() * mag).sum(1),
                         (t64.abs() * mag).sum(1)], 1)
    return (d * d).mean(1), stats, scale


def _merge(x, y):
    """Chan's merge of moment tuples (n, mu_p, mu_t, m2_p, m2_t, c_pt),
    x before y, elementwise in f32 as the kernel's merge()."""
    n = x[0] + y[0]
    f = y[0] / torch.where(n > 0, n, torch.ones_like(n))
    w = x[0] * f
    dp, dt = y[1] - x[1], y[2] - x[2]
    r = (n, x[1] + dp * f, x[2] + dt * f, x[3] + y[3] + dp * dp * w,
         x[4] + y[4] + dt * dt * w, x[5] + y[5] + dp * dt * w)
    return tuple(torch.where(y[0] == 0, xa, torch.where(x[0] == 0, ya, ra))
                 for xa, ya, ra in zip(x, y, r))


def _block_merge(m):
    """The kernel's block tree over the last dimension (256 threads): a
    butterfly over each warp's lanes, lower lane first, then warps 0..7
    in order."""
    m = tuple(v.reshape(*v.shape[:-1], 8, 32) for v in m)
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        other = tuple(v[..., lane ^ off] for v in m)
        upper = (lane & off) != 0
        lo = tuple(torch.where(upper, o, v) for o, v in zip(other, m))
        hi = tuple(torch.where(upper, v, o) for o, v in zip(other, m))
        m = _merge(lo, hi)
    m = tuple(v[..., 0] for v in m)            # [..., 8 warps]
    out = tuple(v[..., 0] for v in m)
    for w in range(1, 8):
        out = _merge(out, tuple(v[..., w] for v in m))
    return out


def _single_pass_model(p, t):
    """csrc/normalized_mse.cu's forward in float32 torch: shift by the
    sample's first element, each thread's 32 elements (lo + 8 tid + 2048
    j + e) to moments in two passes, the block tree per chunk, the last
    CTA's chunk-order merge (thread q takes chunks q, q + 256, ...) and
    the block tree, then m and the six statistics in float64."""
    B = p.shape[0]
    P, T = p.reshape(B, -1).float(), t.reshape(B, -1).float()
    N = P.shape[1]
    kp, kt = P[:, :1], T[:, :1]
    nch = -(-N // nm.CHUNK)
    pad = nch * nm.CHUNK - N

    def threads(x):   # [B, nch, 256, 32] in the kernel's element order
        x = torch.nn.functional.pad(x, (0, pad))
        x = x.reshape(B, nch, nm.PER_THREAD // 8, nm.THREADS, 8)
        return x.permute(0, 1, 3, 2, 4).reshape(B, nch, nm.THREADS,
                                                nm.PER_THREAD)

    valid = threads(torch.ones(B, N)) > 0
    a = torch.where(valid, threads(P - kp), 0.0)
    c = torch.where(valid, threads(T - kt), 0.0)
    cnt = valid.sum(-1).float()
    safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    mu_p, mu_t = a.sum(-1) / safe, c.sum(-1) / safe
    dp = torch.where(valid, a - mu_p[..., None], 0.0)
    dt = torch.where(valid, c - mu_t[..., None], 0.0)
    mo = (cnt, mu_p, mu_t, (dp * dp).sum(-1), (dt * dt).sum(-1),
          (dp * dt).sum(-1))
    chunks = _block_merge(mo)                   # [B, nch]
    rounds = -(-nch // nm.THREADS)
    chunks = tuple(torch.nn.functional.pad(v, (0, rounds * nm.THREADS - nch))
                   .reshape(B, rounds, nm.THREADS) for v in chunks)
    acc = tuple(torch.zeros(B, nm.THREADS) for _ in range(6))
    for r in range(rounds):
        acc = _merge(acc, tuple(v[:, r] for v in chunks))
    n, mp, mt, m2p, m2t, cpt = (v.double() for v in _block_merge(acc))
    mu_p = kp[:, 0].double() + mp
    mu_t = kt[:, 0].double() + mt
    s_p = (m2p / N).sqrt().float().double()
    s_t = (m2t / N).sqrt().float().double()
    A = (s_p.float() + nm.EPS).double()
    Bt = (s_t.float() + nm.EPS).double()
    e = mu_p / A - mu_t / Bt
    m = (m2p / A ** 2 - 2 * cpt / (A * Bt) + m2t / Bt ** 2) / N + e * e
    stats = torch.stack([mu_p, s_p, mu_t, s_t,
                         m2p / A - cpt / Bt + N * mu_p * e,
                         cpt / A - m2t / Bt + N * mu_t * e], 1)
    assert bool((n == N).all())
    return m.float(), stats.float()


def _maps(kind, seed=0):
    g = torch.Generator().manual_seed(seed)
    if kind == "layer1":      # VGGish layer 1 of two samples, post-ReLU
        return (torch.relu(torch.randn(2, 128, 128, 64, generator=g)),
                torch.relu(torch.randn(2, 128, 128, 64, generator=g)))
    if kind == "ragged":      # a last chunk of 40 elements
        n = 3 * nm.CHUNK + 40
        return (torch.relu(torch.randn(3, n, generator=g)),
                torch.relu(torch.randn(3, n, generator=g) * 2 + 0.5))
    if kind == "tiny":        # fewer elements than threads
        return (torch.rand(2, 4, 4, 8, generator=g),
                torch.rand(2, 4, 4, 8, generator=g))
    if kind == "mean_1e3_std":   # |mean| = 1e3 x std
        return (1e3 + torch.randn(2, 64, 64, 64, generator=g),
                -2e3 + 2 * torch.randn(2, 64, 64, 64, generator=g))
    if kind == "bf16":
        return (torch.relu(torch.randn(2, 32, 32, 256, generator=g))
                .bfloat16(),
                torch.relu(torch.randn(2, 32, 32, 256, generator=g))
                .bfloat16())
    raise ValueError(kind)


KINDS = ["layer1", "ragged", "tiny", "mean_1e3_std", "bf16"]


def _assert_stats(m, stats, p, t):
    m64, s64, scale = _oracle(p, t)
    np.testing.assert_allclose(m.double().numpy(), m64.numpy(),
                               rtol=RTOL_MOMENTS)
    np.testing.assert_allclose(stats[:, :4].double().numpy(),
                               s64[:, :4].numpy(), rtol=RTOL_MOMENTS)
    # a0 and b0 to 1e-6 of the sum of their terms' magnitudes (their
    # conditioning: a sum of terms of both signs)
    err = (stats[:, 4:].double() - s64[:, 4:]).abs()
    assert bool((err <= RTOL_MOMENTS * scale).all()), (err / scale).max()


@pytest.mark.parametrize("kind", KINDS)
def test_six_column_plain_statistics(kind):
    p, t = _maps(kind)
    m, stats = nm.normalized_mse_forward_reference(p, t)
    assert stats.shape == (p.shape[0], nm.N_STATS)
    assert stats.dtype == m.dtype == torch.float32
    if kind == "mean_1e3_std":
        # the plain version's f32 d = p / A - t / B carries the 1e3
        # offset, so only its moments hold the float64 bar
        m64, s64, _ = _oracle(p, t)
        np.testing.assert_allclose(stats[:, :4].double().numpy(),
                                   s64[:, :4].numpy(), rtol=RTOL_MOMENTS)
        return
    _assert_stats(m, stats, p, t)
    # the wrapper on the CPU is the plain version
    mw, sw = nm.normalized_mse_forward(p, t)
    assert torch.equal(mw, m) and torch.equal(sw, stats)


@pytest.mark.parametrize("kind", KINDS)
def test_single_pass_model_matches_the_two_pass_oracle(kind):
    p, t = _maps(kind)
    m, stats = _single_pass_model(p, t)
    _assert_stats(m, stats, p, t)


def test_closed_form_dot_products_equal_the_direct_sums():
    """a = sum(u p) and b = sum(u t) from the six statistics (float64), and
    the backward's plain version takes them so: dp, dt from a0, b0 equal
    its direct-sum gradients."""
    g = torch.Generator().manual_seed(4)
    p = torch.relu(torch.randn(3, 16, 16, 64, generator=g)).double()
    t = torch.relu(torch.randn(3, 16, 16, 64, generator=g)).double()
    us = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    _, stats, _ = _oracle(p, t)
    P, T = p.reshape(3, -1), t.reshape(3, -1)
    n = P.shape[1]
    A, B = stats[:, 1:2] + nm.EPS, stats[:, 3:4] + nm.EPS
    u = (2.0 / n) * us[:, None] * (P / A - T / B)
    c = (2.0 / n) * us
    np.testing.assert_allclose((c * stats[:, 4]).numpy(),
                               (u * P).sum(1).numpy(), rtol=1e-12)
    np.testing.assert_allclose((c * stats[:, 5]).numpy(),
                               (u * T).sum(1).numpy(), rtol=1e-12)
    # the moments' closed form of a0 and b0, as the kernel writes them
    mu_p, mu_t = P.mean(1), T.mean(1)
    m2p = ((P - mu_p[:, None]) ** 2).sum(1)
    m2t = ((T - mu_t[:, None]) ** 2).sum(1)
    cpt = ((P - mu_p[:, None]) * (T - mu_t[:, None])).sum(1)
    e = mu_p / A[:, 0] - mu_t / B[:, 0]
    np.testing.assert_allclose(
        (m2p / A[:, 0] - cpt / B[:, 0] + n * mu_p * e).numpy(),
        stats[:, 4].numpy(), rtol=1e-12)
    np.testing.assert_allclose(
        (cpt / A[:, 0] - m2t / B[:, 0] + n * mu_t * e).numpy(),
        stats[:, 5].numpy(), rtol=1e-12)
    m_closed = ((m2p / A[:, 0] ** 2 - 2 * cpt / (A[:, 0] * B[:, 0])
                 + m2t / B[:, 0] ** 2) / n + e * e)
    np.testing.assert_allclose(m_closed.numpy(),
                               ((P / A - T / B) ** 2).mean(1).numpy(),
                               rtol=1e-12)


def test_backward_refuses_four_column_stats():
    p = torch.rand(2, 4, 4, 8)
    _, stats = nm.normalized_mse_forward(p, p.flip(0))
    with pytest.raises(ValueError, match=r"\[B, 6\]"):
        nm.normalized_mse_backward(p, p.flip(0), stats[:, :4],
                                   torch.ones(2), False)

