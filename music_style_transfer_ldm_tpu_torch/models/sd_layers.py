"""The layers Stable Diffusion's UNet and VAE share, named as diffusers
names them (so a published state dict loads as it is), NCHW.

Every GroupNorm runs through ``norm`` (``ops/group_norm.py``): on the
card one channels-last kernel that keeps the norm's input and output
channels-last, with the SiLU after it and the time embedding's add
before it fused in.  The ``nn.GroupNorm`` modules stay, as holders of
the weights under diffusers' names.

* ``ResnetBlock``: GroupNorm, SiLU, 3x3 conv, the time embedding added
  after the first conv (UNet only, fused into the second norm),
  GroupNorm, SiLU, 3x3 conv, and a 1x1 ``conv_shortcut`` where the
  width changes;
* ``Attention``: ``to_q``/``to_k``/``to_v`` (with or without bias) and
  ``to_out.0``, through ``F.scaled_dot_product_attention`` (on the card
  in bf16 the flash kernel takes head dims up to 256);
* ``Downsample`` (3x3 stride-2 conv; the VAE's pads (0, 1, 0, 1) first)
  and ``Upsample`` (nearest 2x, then a 3x3 conv).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.ops.group_norm import group_norm_nhwc


def norm(gn: nn.GroupNorm, x: torch.Tensor, silu: bool = False,
         add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gn`` applied to x (+ ``add`` [B, C] first), then SiLU when
    ``silu``, through the channels-last kernel on the card."""
    return group_norm_nhwc(x, gn.weight, gn.bias, gn.num_groups, gn.eps,
                           silu=silu, add=add)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, temb_dim: Optional[int],
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_dim, cout) if temb_dim
                              else None)
        self.norm2 = nn.GroupNorm(groups, cout, eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(norm(self.norm1, x, silu=True))
        add = (None if self.time_emb_proj is None
               else self.time_emb_proj(F.silu(temb)))
        h = self.conv2(norm(self.norm2, h, silu=True, add=add))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention of [B, N, dim] tokens over ``context`` [B, M,
    context_dim] (itself when None)."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 qkv_bias: bool = False):
        super().__init__()
        context_dim = context_dim or dim
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=qkv_bias)
        self.to_k = nn.Linear(context_dim, dim, bias=qkv_bias)
        self.to_v = nn.Linear(context_dim, dim, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        B, N, C = x.shape

        def split(t):
            return t.reshape(B, -1, self.heads, C // self.heads).transpose(
                1, 2)
        out = F.scaled_dot_product_attention(
            split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx)))
        return self.to_out[0](out.transpose(1, 2).reshape(B, N, C))


class Downsample(nn.Module):
    def __init__(self, channels: int, pad_first: bool = False):
        super().__init__()
        self.pad_first = pad_first
        self.conv = nn.Conv2d(channels, channels, 3, stride=2,
                              padding=0 if pad_first else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_first:
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H W, C]."""
    return x.flatten(2).transpose(1, 2)


def image(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[B, H W, C] -> the layout and shape of ``like`` [B, C, H, W]."""
    B, C, H, W = like.shape
    return t.transpose(1, 2).reshape(B, C, H, W)
