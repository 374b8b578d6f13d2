"""The plain reference of the latent diffusion model and its two feature
trunks, as functions over flat dicts of tensors.

Every tensor is named as in the measured program's state dicts (``LDM``,
``VGGishFeatures``, ``LPIPS``), so the harness loads one dict of weights
into both sides.  Layouts are NCHW.  The geometry follows the model the
program ports (PrioteasaAndrei/music-style-transfer-ldm ``models/``):

* encoder: three 3x3 stride-2 convs (64, 128, latent), BatchNorm on each,
  ReLU on the first two;
* decoder: three 4x4 stride-2 transpose convs (128, 64, 1), BatchNorm and
  ReLU on the first two, tanh last;
* style encoder: six 3x3 stride-2 convs with ReLU; the UNet reads the
  fifth and sixth maps;
* UNet on the 16x16 latent: enc1 (3x3) -> enc2 (s2, + time embedding
  after the ReLU) -> enc3 (s2) -> cross-attention with s5 -> enc4 (s2)
  -> cross-attention with s6 -> bottleneck -> three 3x3 stride-2
  transpose convs (output padding 1) with additive skips -> dec1 (3x3);
* BatchNorm with flax's semantics: biased batch variance E[x^2] - E[x]^2
  clipped at 0, running statistics with momentum 0.9, eps 1e-5.

``Precision`` says how a product is computed: ``float32`` (the
reference) or ``fp8`` (every operand of a convolution, a linear layer or
an attention product rounded to float8 e4m3 under a per-tensor scale,
and the gradient that reaches it to e5m2: the control, one precision
below the bf16 the model is served and trained in).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to ``top``."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Forward: e4m3.  Backward: the incoming gradient in e5m2 (the
    usual split of float8 training)."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class Precision:
    """How the reference rounds the operands of its products."""

    KINDS = ("float32", "fp8")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the product reads it: as it is in float32; in fp8
        rounded to e4m3, and its gradient to e5m2, each under a
        per-tensor scale."""
        if self.kind == "float32":
            return x
        return _Fp8.apply(x)


F32 = Precision("float32")


# ---------------------------------------------------------------- layers

def conv(P: Params, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 1, prec: Precision = F32) -> torch.Tensor:
    return F.conv2d(prec.q(x), prec.q(P[f"{name}.weight"]),
                    P[f"{name}.bias"], stride, padding)


def conv_t(P: Params, name: str, x: torch.Tensor, kernel: int,
           prec: Precision = F32) -> torch.Tensor:
    """Stride-2 transpose conv: kernel 4 (padding 1) or kernel 3
    (padding 1, output padding 1); both double the size."""
    out_pad = 1 if kernel == 3 else 0
    return F.conv_transpose2d(prec.q(x), prec.q(P[f"{name}.weight"]),
                              P[f"{name}.bias"], 2, 1, out_pad)


def linear(P: Params, name: str, x: torch.Tensor,
           prec: Precision = F32) -> torch.Tensor:
    return F.linear(prec.q(x), prec.q(P[f"{name}.weight"]),
                    P[f"{name}.bias"])


def batch_norm(P: Params, name: str, x: torch.Tensor, train: bool,
               new_stats: Optional[dict] = None) -> torch.Tensor:
    """Eval: the running statistics.  Train: the batch's mean and biased
    variance; the updated running statistics go to ``new_stats``."""
    shape = (1, -1, 1, 1)
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if not train:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    else:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        if new_stats is not None:
            m = _BN_MOMENTUM
            new_stats[f"{name}.running_mean"] = (
                m * P[f"{name}.running_mean"] + (1 - m) * mean.detach())
            new_stats[f"{name}.running_var"] = (
                m * P[f"{name}.running_var"] + (1 - m) * var.detach())
    return ((x - mean.reshape(shape)) * torch.rsqrt(var + _BN_EPS).reshape(
        shape) * w.reshape(shape) + b.reshape(shape))


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * -scale)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], -1)


def cross_attention(P: Params, name: str, z: torch.Tensor,
                    style: torch.Tensor, heads: int,
                    prec: Precision = F32) -> torch.Tensor:
    B, C, H, W = z.shape
    hd = C // heads
    q_in = z.flatten(2).transpose(1, 2)
    kv_in = style.flatten(2).transpose(1, 2)
    q = linear(P, f"{name}.q_proj", q_in, prec).reshape(B, -1, heads, hd)
    k = linear(P, f"{name}.k_proj", kv_in, prec).reshape(B, -1, heads, hd)
    v = linear(P, f"{name}.v_proj", kv_in, prec).reshape(B, -1, heads, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", prec.q(q), prec.q(k))
    weights = torch.softmax(logits / math.sqrt(hd), -1)
    att = torch.einsum("bhqk,bkhd->bqhd", prec.q(weights), prec.q(v))
    out = linear(P, f"{name}.out_proj", att.reshape(B, H * W, C), prec)
    return out.transpose(1, 2).reshape(B, C, H, W)


# ---------------------------------------------------------------- the LDM

def encoder(P: Params, x: torch.Tensor, prec: Precision = F32
            ) -> torch.Tensor:
    """[B, 1, 128, 128] -> [B, latent, 16, 16], BatchNorm on its running
    statistics (serving, and the frozen encoder of LDM training)."""
    x = torch.relu(batch_norm(P, "encoder.bn1",
                              conv(P, "encoder.conv1", x, 2, 1, prec), False))
    x = torch.relu(batch_norm(P, "encoder.bn2",
                              conv(P, "encoder.conv2", x, 2, 1, prec), False))
    return batch_norm(P, "encoder.bn3", conv(P, "encoder.conv3", x, 2, 1,
                                             prec), False)


def decoder(P: Params, z: torch.Tensor, train: bool = False,
            new_stats: Optional[dict] = None,
            prec: Precision = F32) -> torch.Tensor:
    """[B, latent, 16, 16] -> [B, 1, 128, 128] in [-1, 1]."""
    z = torch.relu(batch_norm(P, "decoder.bn1",
                              conv_t(P, "decoder.deconv1", z, 4, prec),
                              train, new_stats))
    z = torch.relu(batch_norm(P, "decoder.bn2",
                              conv_t(P, "decoder.deconv2", z, 4, prec),
                              train, new_stats))
    return torch.tanh(conv_t(P, "decoder.deconv3", z, 4, prec))


def style_pyramid(P: Params, s: torch.Tensor, prec: Precision = F32
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 1, 128, 128] -> (s5, s6), the maps the UNet reads."""
    maps = []
    for i in range(1, 7):
        s = torch.relu(conv(P, f"style_encoder.enc{i}", s, 2, 1, prec))
        maps.append(s)
    return maps[4], maps[5]


def unet(P: Params, z: torch.Tensor, t: torch.Tensor, s5: torch.Tensor,
         s6: torch.Tensor, heads: int = 4, prec: Precision = F32
         ) -> torch.Tensor:
    dim = P["unet.time_fc1.weight"].shape[1]
    temb = linear(P, "unet.time_fc2", F.gelu(
        linear(P, "unet.time_fc1", sinusoidal(t, dim), prec),
        approximate="tanh"), prec)[:, :, None, None]
    z1 = torch.relu(conv(P, "unet.enc1", z, 1, 1, prec))
    z2 = torch.relu(conv(P, "unet.enc2", z1, 2, 1, prec)) + temb
    z3 = torch.relu(conv(P, "unet.enc3", z2, 2, 1, prec))
    z3a = cross_attention(P, "unet.cross_attention2", z3, s5, heads, prec)
    z4 = torch.relu(conv(P, "unet.enc4", z3a, 2, 1, prec))
    z4 = cross_attention(P, "unet.cross_attention1", z4, s6, heads, prec)
    z4 = torch.relu(conv(P, "unet.bottleneck", z4, 1, 1, prec))
    u3 = torch.relu(conv_t(P, "unet.dec4", z4, 3, prec)) + z3
    u2 = torch.relu(conv_t(P, "unet.dec3", u3, 3, prec)) + z2
    u1 = torch.relu(conv_t(P, "unet.dec2", u2, 3, prec)) + z1
    return conv(P, "unet.dec1", u1, 1, 1, prec)


# ---------------------------------------------------------------- trunks

VGGISH = (("conv1", True), ("conv2", True), ("conv3_1", False),
          ("conv3_2", True), ("conv4_1", False), ("conv4_2", True))


def vggish_maps(P: Params, x: torch.Tensor, prec: Precision = F32):
    """The six post-ReLU maps of the VGGish trunk (3x3 convs, 2x2
    max-pools after conv1, conv2 and conv3_2) from [B, 1, H, W]."""
    maps = []
    for i, (name, pool) in enumerate(VGGISH):
        x = torch.relu(conv(P, name, x, 1, 1, prec))
        maps.append(x)
        if pool and i < len(VGGISH) - 1:
            x = F.max_pool2d(x, 2)
    return maps


ALEX = (("conv1", 4, 2, False), ("conv2", 1, 2, True),
        ("conv3", 1, 1, True), ("conv4", 1, 1, False),
        ("conv5", 1, 1, False))


def alex_maps(P: Params, x: torch.Tensor, prec: Precision = F32):
    """The five post-ReLU maps of LPIPS's AlexNet trunk (3x3 stride-2
    max-pools before conv2 and conv3)."""
    maps = []
    for name, stride, pad, pool in ALEX:
        if pool:
            x = F.max_pool2d(x, 3, 2)
        x = torch.relu(conv(P, f"alex.{name}", x, stride, pad, prec))
        maps.append(x)
    return maps
