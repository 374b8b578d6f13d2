"""Latent-space denoising UNet with time conditioning and style
cross-attention, NCHW.

  enc1 (->64ch @16x16) -> enc2 (->128ch @8x8, + time embedding after the
  ReLU) -> enc3 (->256ch @4x4) -> cross-attn with s5 -> enc4 (->512ch
  @2x2) -> cross-attn with s6 -> bottleneck -> three k3 s2 transpose
  convs with additive skips to the pre-attention activations -> 3x3 conv
  back to latent_dim channels.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.models.layers import (
    CrossAttention, conv_s1, conv_s2, convT_k3, gelu_tanh,
    sinusoidal_embedding,
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

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """t[B] -> [B, time_emb_dim] in the weights' dtype."""
        dt = self.time_fc1.weight.dtype
        temb = sinusoidal_embedding(t, self.time_emb_dim).to(dt)
        return self.time_fc2(gelu_tanh(self.time_fc1(temb)))

    def forward(self, z: torch.Tensor, t: torch.Tensor,
                style: Dict[str, torch.Tensor]) -> torch.Tensor:
        temb = self.time_embedding(t)[:, :, None, None]
        z = z.to(self.enc1.weight.dtype)
        z1 = torch.relu(self.enc1(z))
        z2 = torch.relu(self.enc2(z1)) + temb
        z3 = torch.relu(self.enc3(z2))
        z3a = self.cross_attention2(z3, style["s5"])
        z4 = torch.relu(self.enc4(z3a))
        z4 = self.cross_attention1(z4, style["s6"])
        z4 = torch.relu(self.bottleneck(z4))
        u3 = torch.relu(self.dec4(z4)) + z3
        u2 = torch.relu(self.dec3(u3)) + z2
        u1 = torch.relu(self.dec2(u2)) + z1
        return self.dec1(u1)
