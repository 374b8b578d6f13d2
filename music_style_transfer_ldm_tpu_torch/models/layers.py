"""Shared building blocks in NCHW: the convolution geometries, the
sinusoidal time embedding, style cross-attention and BatchNorm with
flax's semantics.

Geometry map from the JAX package's flax layers:
* ``conv_s1`` / ``conv_s2``: k3 convs, stride 1 / 2, padding 1;
* ``convT_k3`` (VALID + crop of the first row and column) is exactly
  ``ConvTranspose2d(k3, s2, p1, output_padding=1)``;
* ``convT_k4`` (flax SAME) is ``ConvTranspose2d(k4, s2, p1)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv_s1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=1, padding=1)


def conv_s2(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=2, padding=1)


def convT_k3(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                              output_padding=1)


def convT_k4(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


def sinusoidal_embedding(time: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """Transformer-style timestep embedding [B] -> [B, dim] (f32):
    scale = log(1e4)/(half-1), then [sin, cos]."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=time.device) * -scale)
    args = time.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class CrossAttention(nn.Module):
    """UNet features (queries) attend to style features (keys/values).

    Separate q/k/v/out projections with bias; logits divided by
    sqrt(head_dim); products accumulate and the softmax runs in f32.
    """

    def __init__(self, embed_dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, z: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """z [B, C, H, W], style [B, C, h, w] -> [B, C, H, W]."""
        B, C, H, W = z.shape
        nh, hd = self.num_heads, C // self.num_heads
        q_in = z.flatten(2).transpose(1, 2)          # [B, HW, C]
        kv_in = style.flatten(2).transpose(1, 2)     # [B, hw, C]
        q = self.q_proj(q_in).reshape(B, -1, nh, hd)
        k = self.k_proj(kv_in).reshape(B, -1, nh, hd)
        v = self.v_proj(kv_in).reshape(B, -1, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits / math.sqrt(hd), dim=-1)
        attended = torch.einsum("bhqk,bkhd->bqhd",
                                weights.to(q.dtype).float(), v.float())
        attended = attended.to(z.dtype).reshape(B, H * W, C)
        out = self.out_proj(attended)
        return out.transpose(1, 2).reshape(B, C, H, W)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax ``nn.BatchNorm(momentum=0.9)`` semantics.

    ``train`` is explicit, as flax's ``use_running_average=not train``:
    False normalises with the running statistics whatever the module's
    mode.  True normalises with the batch mean and the *biased* batch
    variance, E[x^2] - E[x]^2 clipped at 0 (torch's BatchNorm2d updates
    its running variance with the unbiased one), and updates the running
    statistics with both: ra = m * ra + (1 - m) * batch, m = 0.9.
    Statistics and normalisation in f32, the result in the input's
    dtype."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        x32 = x.float()
        mean = x32.mean((0, 2, 3))
        var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean, min=0.0)
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.float().reshape(shape)).to(x.dtype)
