"""Stable Diffusion 1.5's text-conditioned UNet (diffusers'
``UNet2DConditionModel`` as riffusion/riffusion-model-v1 configures it),
NCHW, named as diffusers names it.

* time: 320 sinusoids (cos first, shift 0) -> Linear 320->1280, SiLU,
  Linear 1280->1280; each ResNet adds Linear(SiLU(temb)) after its
  first conv;
* down: ``conv_in`` 4->320, then per level two (ResNet, Transformer2D)
  pairs (plain ResNets at the last level) and a 3x3 stride-2 conv (not
  at the last level); every output is a skip (12 in all);
* mid: ResNet, Transformer2D, ResNet;
* up: per level three ResNets on the concatenated skips (each followed
  by a Transformer2D where the mirrored down level has one), then
  nearest 2x and a 3x3 conv (not at the last level);
* out: GroupNorm, SiLU, ``conv_out`` 320->4.

Every GroupNorm goes through ``sd_layers.norm``, so on the card the
activations stay channels-last through the norms.

Transformer2D: GroupNorm (eps 1e-6), a 1x1 ``proj_in``, one block
x += SelfAttn(LN x); x += CrossAttn(LN x, text); x += FF(LN x) with a
GEGLU feed-forward (Linear C->8C, a * gelu(gate), Linear 4C->C), a 1x1
``proj_out``, plus the input.  Widths (320, 640, 1280, 1280), 8 heads
everywhere: 859,520,964 parameters.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.config import SDUNetConfig
from music_style_transfer_ldm_tpu_torch.models.sd_layers import (
    Attention, Downsample, ResnetBlock, Upsample, image, norm, tokens,
)


def timestep_sinusoids(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' ``Timesteps(dim, flip_sin_to_cos=True,
    downscale_freq_shift=0)``: [B] -> [B, dim] f32, cosines first."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, -1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        # net.1 is diffusers' dropout (p 0): kept so net.2 keeps its name
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.net:
            x = layer(x)
        return x


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int, groups: int,
                 eps: float):
        super().__init__()
        self.norm = nn.GroupNorm(groups, dim, eps)
        self.proj_in = nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(dim, heads, context_dim)])
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        h = self.proj_in(norm(self.norm, x))
        t = tokens(h)
        for block in self.transformer_blocks:
            t = block(t, context)
        return self.proj_out(image(t, h)) + x


class _Level(nn.Module):
    """A down or up block: ``resnets``, ``attentions`` (possibly none)
    and a resampler (``downsamplers`` / ``upsamplers``, possibly none)."""

    def __init__(self, resnets: List[nn.Module], attentions: List[nn.Module],
                 sampler_name: str, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        else:
            self.attentions = None
        self.sampler_name = sampler_name
        setattr(self, sampler_name,
                nn.ModuleList([sampler]) if sampler is not None else None)

    def layers(self):
        attns = self.attentions or [None] * len(self.resnets)
        return zip(self.resnets, attns)

    def resample(self, x: torch.Tensor) -> torch.Tensor:
        sampler = getattr(self, self.sampler_name)
        return x if sampler is None else sampler[0](x)


class SDUNet(nn.Module):
    """eps prediction: (x [B, 4, H, W], t [B], text [B, 77, 768]) -> [B, 4,
    H, W] in the model's type, contiguous."""

    def __init__(self, config: SDUNetConfig = SDUNetConfig()):
        super().__init__()
        c = config
        chans = list(c.block_out_channels)
        temb = c.time_embed_dim
        self.time_proj_dim = c.time_proj_dim
        self.conv_in = nn.Conv2d(c.in_channels, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(c.time_proj_dim, temb)

        def res(cin, cout):
            return ResnetBlock(cin, cout, temb, c.groups, c.eps)

        def attn(dim):
            return Transformer2D(dim, c.heads, c.cross_attention_dim,
                                 c.groups, c.transformer_eps)

        n = len(chans)
        self.down_blocks = nn.ModuleList()
        cout = chans[0]
        for i in range(n):
            cin, cout = cout, chans[i]
            last = i == n - 1
            self.down_blocks.append(_Level(
                [res(cin if j == 0 else cout, cout)
                 for j in range(c.layers_per_block)],
                [attn(cout) for _ in range(c.layers_per_block)]
                if c.cross_attention[i] else [],
                "downsamplers", None if last else Downsample(cout)))
        self.mid_block = _Level([res(chans[-1], chans[-1]),
                                 res(chans[-1], chans[-1])],
                                [attn(chans[-1])], "upsamplers", None)
        rev = chans[::-1]
        cross = list(c.cross_attention)[::-1]
        self.up_blocks = nn.ModuleList()
        out = rev[0]
        for i in range(n):
            prev, out = out, rev[i]
            skip_in = rev[min(i + 1, n - 1)]
            k = c.layers_per_block + 1
            self.up_blocks.append(_Level(
                [res((prev if j == 0 else out)
                     + (skip_in if j == k - 1 else out), out)
                 for j in range(k)],
                [attn(out) for _ in range(k)] if cross[i] else [],
                "upsamplers", None if i == n - 1 else Upsample(out)))
        self.conv_norm_out = nn.GroupNorm(c.groups, chans[0], c.eps)
        self.conv_out = nn.Conv2d(chans[0], c.out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(
            timestep_sinusoids(t, self.time_proj_dim).to(dtype))
        context = context.to(dtype)
        h = self.conv_in(x.to(dtype=dtype, memory_format=torch.channels_last))
        skips = [h]
        for block in self.down_blocks:
            for resnet, attn in block.layers():
                h = resnet(h, temb)
                if attn is not None:
                    h = attn(h, context)
                skips.append(h)
            if block.downsamplers is not None:
                h = block.resample(h)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, temb)
        for block in self.up_blocks:
            for resnet, attn in block.layers():
                h = resnet(torch.cat([h, skips.pop()], 1), temb)
                if attn is not None:
                    h = attn(h, context)
            h = block.resample(h)
        h = self.conv_out(norm(self.conv_norm_out, h, silu=True))
        return h.contiguous()
