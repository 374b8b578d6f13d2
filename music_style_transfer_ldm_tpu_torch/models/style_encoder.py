"""Multi-resolution style pyramid encoder in NCHW.

Six stride-2 convs with ReLU produce s1..s6 at 64x64 .. 2x2; the UNet
reads s5 and s6.  Parameter count: 2,729,984.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.models.layers import conv_s2


class StyleEncoder(nn.Module):
    """[B, 1, 128, 128] -> dict of NCHW maps s1..s6."""

    def __init__(self, num_filters: int = 64):
        super().__init__()
        nf = num_filters
        chans = [(1, nf), (nf, nf * 2), (nf * 2, nf * 4), (nf * 4, nf * 4),
                 (nf * 4, nf * 4), (nf * 4, nf * 8)]
        for i, (ci, co) in enumerate(chans, 1):
            setattr(self, f"enc{i}", conv_s2(ci, co))

    def forward(self, style: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        x = style
        for i in range(1, 7):
            x = torch.relu(getattr(self, f"enc{i}")(x))
            out[f"s{i}"] = x
        return out
