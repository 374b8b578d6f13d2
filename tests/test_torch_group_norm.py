"""The channels-last GroupNorm op (``ops/group_norm.py``) and the SD
models' use of it.

On the CPU the op runs its plain version: held against ``F.group_norm``
in f64 (then SiLU, with and without the addend) at every group width
Riffusion has, in layout, and counted once per ``nn.GroupNorm`` module
in a forward of a reduced UNet and VAE.  Tests marked ``card`` hold the
CUDA kernel against the plain version on a card and skip without one.
This file imports no JAX, so the card's machine runs it:

    python -m pytest tests/test_torch_group_norm.py --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.config import SDUNetConfig, VAEConfig
from music_style_transfer_ldm_tpu_torch.models.sd_unet import SDUNet
from music_style_transfer_ldm_tpu_torch.models.vae_kl import AutoencoderKL
from music_style_transfer_ldm_tpu_torch.ops import group_norm as gn
from music_style_transfer_ldm_tpu_torch.utils import profiling

# Riffusion's group widths (C / 32): the UNet's 10-80, the VAE's 4-16.
WIDTHS = (4, 8, 10, 16, 20, 30, 40, 60, 80)
MODES = ("norm", "silu", "silu+add")


def _inputs(shape, seed, dtype=torch.float32, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    N, C = shape[:2]

    def t(*s, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(s, generator=g, device=device)
                ).to(dtype)
    return (t(*shape, scale=2.0, shift=0.5), t(C, scale=0.2, shift=1.0),
            t(C, scale=0.2), t(N, C))


def _want(x, w, b, groups, eps, silu, add):
    """f64 of F.group_norm over x + add (the add rounded to x's type)."""
    if add is not None:
        x = x + add.to(x.dtype)[:, :, None, None]
    y = F.group_norm(x.double(), groups, w.double(), b.double(), eps)
    return F.silu(y) if silu else y


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", MODES)
def test_plain_version_matches_group_norm(width, batch, mode):
    x, w, b, add = _inputs((batch, 32 * width, 5, 7), width + batch)
    silu, add = mode != "norm", add if mode == "silu+add" else None
    got = gn.group_norm_nhwc(x, w, b, 32, 1e-5, silu=silu, add=add)
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got.double(),
                               _want(x, w, b, 32, 1e-5, silu, add),
                               rtol=0, atol=1e-5)


def test_plain_version_rounds_the_add_to_the_input_type():
    x, w, b, add = _inputs((2, 64, 3, 5), 3)
    xb = x.bfloat16()
    got = gn.group_norm_nhwc(xb, w.bfloat16(), b.bfloat16(), 32, 1e-5,
                             silu=True, add=add)
    want = F.silu(F.group_norm(xb + add.bfloat16()[:, :, None, None], 32,
                               w.bfloat16(), b.bfloat16(), 1e-5))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_channels_last_in_channels_last_out(mode):
    x, w, b, add = _inputs((3, 96, 9, 11), 5)
    x = x.contiguous(memory_format=torch.channels_last)
    silu, add = mode != "norm", add if mode == "silu+add" else None
    got = gn.group_norm_nhwc(x, w, b, 32, 1e-6, silu=silu, add=add)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert not got.is_contiguous()
    torch.testing.assert_close(got.double(),
                               _want(x, w, b, 32, 1e-6, silu, add),
                               rtol=0, atol=1e-5)


def _counted(fn):
    tracer = profiling.enable()
    try:
        with torch.no_grad():
            fn()
    finally:
        profiling.disable()
    return tracer.counters.get("group_norm.calls", 0)


def _norms(module):
    return sum(isinstance(m, nn.GroupNorm) for m in module.modules())


def test_every_unet_norm_goes_through_the_op():
    torch.manual_seed(0)
    unet = SDUNet(SDUNetConfig(
        block_out_channels=(32, 64), cross_attention=(True, False),
        layers_per_block=1, heads=4, cross_attention_dim=32, groups=8,
        time_proj_dim=32, time_embed_dim=64)).eval()
    x = torch.randn(2, 4, 8, 8)
    calls = _counted(lambda: unet(x, torch.tensor([3, 700]),
                                  torch.randn(2, 77, 32)))
    assert _norms(unet) == 21
    assert calls == _norms(unet)


def test_every_vae_norm_goes_through_the_op():
    torch.manual_seed(0)
    vae = AutoencoderKL(VAEConfig(block_out_channels=(16, 32),
                                  layers_per_block=1, groups=8)).eval()
    x = torch.rand(2, 3, 16, 16) * 2 - 1
    enc = _counted(lambda: vae.encode_mean(x))
    dec = _counted(lambda: vae.decode(torch.randn(2, 4, 8, 8)))
    assert (enc, dec) == (_norms(vae.encoder), _norms(vae.decoder))
    assert enc + dec == _norms(vae) == 24


def test_riffusion_norm_counts():
    """At full size: 61 norms a UNet call, 22 in the VAE's encoder and 30
    in its decoder, so 37 x 61 + 22 + 30 = 2,309 a served dispatch."""
    with torch.device("meta"):
        unet, vae = SDUNet(SDUNetConfig()), AutoencoderKL(VAEConfig())
    assert (_norms(unet), _norms(vae.encoder), _norms(vae.decoder)) == (
        61, 22, 30)


def test_no_kernel_off_the_cpu_and_the_card():
    x, w = torch.zeros(1, 32, 4, 4, device="meta"), torch.ones(32)
    with pytest.raises(RuntimeError, match="no kernel"):
        gn.group_norm_nhwc(x, w, w, 8, 1e-5)


# ---- on a card --------------------------------------------------------

# Riffusion's norms at 512x512: the UNet at 8 guided rows, the VAE at 4
# clips (group widths 10, 30, 20, 60, 80, 40; 4, 8, 16), and two widths
# that take the kernel's one-channel loads (C % 8 != 0).
CARD_SHAPES = ((8, 320, 64, 64), (8, 960, 64, 64), (8, 640, 32, 32),
               (8, 1920, 32, 32), (8, 2560, 8, 8), (8, 1280, 16, 16),
               (4, 128, 512, 512), (4, 256, 256, 256), (4, 512, 128, 128),
               (1, 30, 5, 7), (3, 100, 9, 11))
# f32 kernel vs f64: f32 sums and __expf / __fdividef in the SiLU.  bf16
# kernel vs f64 on the same bf16 input: one rounding to bf16 (2^-9 of
# the value), with room.
TOL_F32 = 2e-5
TOL_BF16_REL, TOL_BF16_ABS = 2.0 ** -8, 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _card_inputs(shape, dtype, mode, dev):
    x, w, b, add = _inputs(shape, sum(shape), dtype, dev)
    groups = 32 if shape[1] % 32 == 0 else 10
    return (x.contiguous(memory_format=torch.channels_last), w, b, groups,
            mode != "norm", add if mode == "silu+add" else None)


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_matches_plain_version(shape, dtype, mode):
    dev = _card()
    x, w, b, groups, silu, add = _card_inputs(shape, dtype, mode, dev)
    launches = gn.group_norm_nhwc.launches
    got = gn.group_norm_nhwc(x, w, b, groups, 1e-5, silu=silu, add=add)
    torch.cuda.synchronize()
    assert gn.group_norm_nhwc.launches == launches + 1
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = _want(x, w, b, groups, 1e-5, silu, add)
    err = (got.double() - want).abs()
    if dtype == torch.float32:
        assert err.max().item() <= TOL_F32 * max(1.0, want.abs().max().item())
    else:
        assert (err - TOL_BF16_REL * want.abs()).max().item() <= TOL_BF16_ABS


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_gives_the_same_bits_twice(dtype):
    dev = _card()
    x, w, b, groups, silu, add = _card_inputs((4, 512, 128, 128), dtype,
                                              "silu+add", dev)
    first = gn.group_norm_nhwc(x, w, b, groups, 1e-6, silu=silu, add=add)
    second = gn.group_norm_nhwc(x, w, b, groups, 1e-6, silu=silu, add=add)
    assert torch.equal(first, second)


@pytest.mark.card
def test_kernel_refuses_nchw():
    dev = _card()
    x, w, b, *_ = _card_inputs((2, 64, 8, 8), torch.bfloat16, "norm", dev)
    with pytest.raises(ValueError, match="channels-last"):
        gn.group_norm_nhwc(x.contiguous(), w, b, 32, 1e-5)
    with pytest.raises(ValueError, match="groups"):
        gn.group_norm_nhwc(x, w, b, 24, 1e-5)
