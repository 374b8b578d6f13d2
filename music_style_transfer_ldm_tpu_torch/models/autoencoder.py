"""Spectrogram autoencoder in NCHW.

Encoder: three stride-2 convs to a [latent_dim, 16, 16] latent, with
BatchNorm (eps 1e-5, flax momentum 0.9; ``models/layers.py``) and ReLU
on the first two, BN only on the last.  Decoder: three k4 s2 transpose
convs ending in tanh.  Parameter counts: encoder 111,840, decoder
198,209.  ``train`` is explicit, as in flax: False (inference, the
frozen encoder of LDM training) normalises with the running statistics,
True with the batch's and updates the running ones.  In train mode
``sample_weights`` ([B] validity, 0 for a pad row) keeps pad rows out of
every BatchNorm's statistics and ``group`` takes them over every rank
(``models/layers.py BatchNorm``).  ``ax`` runs them under a model axis
(``models/layers.py``: tensor or sequence parallelism).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.models.layers import (
    BatchNorm, conv, conv_s2, convT_k4,
)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, momentum=0.9, eps=1e-5)


class SpectrogramEncoder(nn.Module):
    """[B, 1, 128, 128] -> [B, latent_dim, 16, 16]."""

    def __init__(self, latent_dim: int = 32):
        super().__init__()
        self.conv1, self.bn1 = conv_s2(1, 64), _bn(64)
        self.conv2, self.bn2 = conv_s2(64, 128), _bn(128)
        self.conv3, self.bn3 = conv_s2(128, latent_dim), _bn(latent_dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                sample_weights: Optional[torch.Tensor] = None,
                group=None, ax=None) -> torch.Tensor:
        bn = dict(mask=sample_weights, group=group, ax=ax)
        x = torch.relu(self.bn1(conv(self.conv1, x, ax), train, **bn))
        x = torch.relu(self.bn2(conv(self.conv2, x, ax), train, **bn))
        return self.bn3(conv(self.conv3, x, ax), train, **bn)


class SpectrogramDecoder(nn.Module):
    """[B, latent_dim, 16, 16] -> [B, 1, 128, 128] in [-1, 1]."""

    def __init__(self, latent_dim: int = 32):
        super().__init__()
        self.deconv1, self.bn1 = convT_k4(latent_dim, 128), _bn(128)
        self.deconv2, self.bn2 = convT_k4(128, 64), _bn(64)
        self.deconv3 = convT_k4(64, 1)

    def forward(self, z: torch.Tensor, train: bool = False,
                sample_weights: Optional[torch.Tensor] = None,
                group=None, ax=None) -> torch.Tensor:
        bn = dict(mask=sample_weights, group=group, ax=ax)
        z = torch.relu(self.bn1(conv(self.deconv1, z, ax), train, **bn))
        z = torch.relu(self.bn2(conv(self.deconv2, z, ax), train, **bn))
        return torch.tanh(conv(self.deconv3, z, ax))
