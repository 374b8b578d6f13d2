"""Shared building blocks in NCHW: the convolution geometries, the
sinusoidal time embedding, style cross-attention and BatchNorm with
flax's semantics (with its pad-row mask, synchronised over ranks).

Geometry map from the JAX package's flax layers:
* ``conv_s1`` / ``conv_s2``: k3 convs, stride 1 / 2, padding 1;
* ``convT_k3`` (VALID + crop of the first row and column) is exactly
  ``ConvTranspose2d(k3, s2, p1, output_padding=1)``;
* ``convT_k4`` (flax SAME) is ``ConvTranspose2d(k4, s2, p1)``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    all_reduce_sum,
)


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
    dtype.

    In train mode ``mask`` ([B], > 0 for a real row) leaves the pad rows
    out of the statistics (they are normalised all the same), as flax's
    ``mask=``; ``group`` (a process group) takes the statistics over
    every rank's rows: the sums S1 = sum x m, S2 = sum x^2 m and the
    count sum m H W go through one differentiable all_reduce, and every
    rank updates its running statistics with the same values.  With
    neither, the statistics are the plain means below.  Not
    ``torch.nn.SyncBatchNorm``: its running variance is the unbiased one
    and it takes no mask."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def _masked_stats(self, x32: torch.Tensor, mask, group):
        """(mean, biased var) over (N, H, W) of the rows ``mask`` keeps,
        over every rank of ``group``."""
        if mask is None:
            s1, s2 = x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))
            count = torch.full((1,), float(x32.shape[0]), device=x32.device)
        else:
            m = (mask > 0).float().reshape(-1, 1, 1, 1)
            xm = x32 * m
            s1, s2 = xm.sum((0, 2, 3)), (xm * x32).sum((0, 2, 3))
            count = m.sum().reshape(1)
        count = count * float(x32.shape[2] * x32.shape[3])
        sums = torch.cat([s1, s2, count])
        if group is not None:
            sums = all_reduce_sum(sums, group, differentiable=True)
        c = self.num_features
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        return mean, var

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if not train:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        x32 = x.float()
        if mask is None and group is None:
            mean = x32.mean((0, 2, 3))
            var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
        else:
            mean, var = self._masked_stats(x32, mask, group)
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape)
        return (y + self.bias.float().reshape(shape)).to(x.dtype)
