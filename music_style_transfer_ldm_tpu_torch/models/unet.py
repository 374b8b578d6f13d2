"""Latent-space denoising UNet with time conditioning and style
cross-attention, NCHW.

  enc1 (->64ch @16x16) -> enc2 (->128ch @8x8, + time embedding after the
  ReLU) -> enc3 (->256ch @4x4) -> cross-attn with s5 -> enc4 (->512ch
  @2x2) -> cross-attn with s6 -> bottleneck -> three k3 s2 transpose
  convs with additive skips to the pre-attention activations -> 3x3 conv
  back to latent_dim channels.

Under a model axis ``ax`` (``models/layers.py``) the layers run tensor
or sequence parallel; with sequence parallelism a level whose width
block turns odd (enc4 at 128-wide images and a model axis of 4) runs on
the whole width down to the bottleneck and is split again by the
matching transpose conv on the way up.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.models.layers import (
    CrossAttention, conv, conv_down, conv_s1, conv_s2, conv_up, convT_k3,
    gelu_tanh, linear, sinusoidal_embedding,
)


class UNet(nn.Module):
    """([B, C_lat, 16, 16], t[B], style pyramid) -> [B, C_lat, 16, 16]."""

    def __init__(self, in_channels: int = 32, out_channels: int = 32,
                 num_filters: int = 64, time_emb_dim: int = 128,
                 num_heads: int = 4):
        super().__init__()
        nf = num_filters
        self.time_emb_dim = time_emb_dim
        self.time_fc1 = nn.Linear(time_emb_dim, time_emb_dim)
        self.time_fc2 = nn.Linear(time_emb_dim, time_emb_dim)
        self.enc1 = conv_s1(in_channels, nf)
        self.enc2 = conv_s2(nf, nf * 2)
        self.enc3 = conv_s2(nf * 2, nf * 4)
        self.cross_attention2 = CrossAttention(nf * 4, num_heads)
        self.enc4 = conv_s2(nf * 4, nf * 8)
        self.cross_attention1 = CrossAttention(nf * 8, num_heads)
        self.bottleneck = conv_s1(nf * 8, nf * 8)
        self.dec4 = convT_k3(nf * 8, nf * 4)
        self.dec3 = convT_k3(nf * 4, nf * 2)
        self.dec2 = convT_k3(nf * 2, nf)
        self.dec1 = conv_s1(nf, out_channels)

    def time_embedding(self, t: torch.Tensor, ax=None) -> torch.Tensor:
        """t[B] -> [B, time_emb_dim] in the weights' dtype."""
        dt = self.time_fc1.weight.dtype
        temb = sinusoidal_embedding(t, self.time_emb_dim).to(dt)
        return linear(self.time_fc2,
                      gelu_tanh(linear(self.time_fc1, temb, ax)), ax)

    def forward(self, z: torch.Tensor, t: torch.Tensor,
                style: Dict[str, torch.Tensor], ax=None) -> torch.Tensor:
        temb = self.time_embedding(t, ax)[:, :, None, None]
        z = z.to(self.enc1.weight.dtype)
        z1 = torch.relu(conv(self.enc1, z, ax))
        z2, sh2 = conv_down(self.enc2, z1, ax)
        z2 = torch.relu(z2) + temb
        z3, sh3 = conv_down(self.enc3, z2, ax, sh2)
        z3 = torch.relu(z3)
        z3a = self.cross_attention2(z3, style["s5"], ax)
        z4, sh4 = conv_down(self.enc4, z3a, ax, sh3)
        z4 = self.cross_attention1(torch.relu(z4), style["s6"], ax)
        z4 = torch.relu(conv(self.bottleneck, z4, ax, sh4))
        u3 = torch.relu(conv_up(self.dec4, z4, ax, sh4, sh3)) + z3
        u2 = torch.relu(conv_up(self.dec3, u3, ax, sh3, sh2)) + z2
        u1 = torch.relu(conv_up(self.dec2, u2, ax, sh2)) + z1
        return conv(self.dec1, u1, ax)
