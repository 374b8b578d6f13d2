"""Stable Diffusion's KL autoencoder (diffusers' ``AutoencoderKL``), NCHW,
named as diffusers names it.

Encoder: ``conv_in`` 3->128, four levels of two ResNets (128, 256, 512,
512), each but the last ending in pad (0, 1, 0, 1) and a 3x3 stride-2
conv; a mid block (ResNet, single-head attention over every position,
ResNet); GroupNorm, SiLU, ``conv_out`` to the latent's mean and log
variance; ``quant_conv`` 1x1.  Decoder: ``post_quant_conv`` 1x1,
``conv_in`` 4->512, the mid block, four levels of three ResNets (512,
512, 256, 128), each but the last ending in nearest 2x and a 3x3 conv;
GroupNorm, SiLU, ``conv_out`` 128->3.  GroupNorm eps 1e-6.  The
latent is the mean times 0.18215; 83,653,863 parameters.  Every
GroupNorm goes through ``sd_layers.norm``, so on the card the
activations stay channels-last through the norms.
"""

from __future__ import annotations

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.config import VAEConfig
from music_style_transfer_ldm_tpu_torch.models.sd_layers import (
    Attention, Downsample, ResnetBlock, Upsample, image, norm, tokens,
)


class SpatialAttention(Attention):
    """GroupNorm, one head over every position, ``to_out``, plus the
    input (diffusers' VAE attention, q/k/v with biases)."""

    def __init__(self, dim: int, groups: int, eps: float):
        super().__init__(dim, 1, qkv_bias=True)
        self.group_norm = nn.GroupNorm(groups, dim, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = norm(self.group_norm, x)
        return image(super().forward(tokens(h)), h) + x


class _MidBlock(nn.Module):
    def __init__(self, dim: int, groups: int, eps: float):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(dim, dim, None, groups, eps) for _ in range(2)])
        self.attentions = nn.ModuleList([SpatialAttention(dim, groups, eps)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _Level(nn.Module):
    def __init__(self, resnets, sampler_name: str, sampler):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_name = sampler_name
        setattr(self, sampler_name,
                nn.ModuleList([sampler]) if sampler is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        sampler = getattr(self, self.sampler_name)
        return x if sampler is None else sampler[0](x)


class VAEEncoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        chans = list(c.block_out_channels)
        self.conv_in = nn.Conv2d(c.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cout = chans[0]
        for i, ch in enumerate(chans):
            cin, cout = cout, ch
            self.down_blocks.append(_Level(
                [ResnetBlock(cin if j == 0 else cout, cout, None, c.groups,
                             c.eps) for j in range(c.layers_per_block)],
                "downsamplers",
                None if i == len(chans) - 1
                else Downsample(cout, pad_first=True)))
        self.mid_block = _MidBlock(chans[-1], c.groups, c.eps)
        self.conv_norm_out = nn.GroupNorm(c.groups, chans[-1], c.eps)
        self.conv_out = nn.Conv2d(chans[-1], 2 * c.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(norm(self.conv_norm_out, x, silu=True))


class VAEDecoder(nn.Module):
    def __init__(self, c: VAEConfig):
        super().__init__()
        rev = list(c.block_out_channels)[::-1]
        self.conv_in = nn.Conv2d(c.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _MidBlock(rev[0], c.groups, c.eps)
        self.up_blocks = nn.ModuleList()
        out = rev[0]
        for i, ch in enumerate(rev):
            prev, out = out, ch
            self.up_blocks.append(_Level(
                [ResnetBlock(prev if j == 0 else out, out, None, c.groups,
                             c.eps) for j in range(c.layers_per_block + 1)],
                "upsamplers", None if i == len(rev) - 1 else Upsample(out)))
        self.conv_norm_out = nn.GroupNorm(c.groups, rev[-1], c.eps)
        self.conv_out = nn.Conv2d(rev[-1], c.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(norm(self.conv_norm_out, x, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.scaling_factor = config.scaling_factor
        self.latent_channels = config.latent_channels
        self.encoder = VAEEncoder(config)
        self.decoder = VAEDecoder(config)
        lat = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode_mean(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] in [-1, 1] -> the scaled latent mean [B, 4, H/8,
        W/8], in the model's type."""
        w = self.quant_conv.weight
        x = x.to(dtype=w.dtype, memory_format=torch.channels_last)
        moments = self.quant_conv(self.encoder(x))
        return moments[:, :self.latent_channels] * self.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, 4, h, w] -> [B, 3, 8h, 8w], about [-1, 1]
        (not clamped), in the model's type."""
        w = self.post_quant_conv.weight
        z = (z / self.scaling_factor).to(dtype=w.dtype,
                                         memory_format=torch.channels_last)
        return self.decoder(self.post_quant_conv(z))
