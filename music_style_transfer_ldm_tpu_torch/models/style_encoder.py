"""Multi-resolution style pyramid encoder in NCHW.

Six stride-2 convs with ReLU produce s1..s6 at 64x64 .. 2x2; the UNet
reads s5 and s6.  Parameter count: 2,729,984.  Under a model axis ``ax``
(``models/layers.py``) with sequence parallelism the style clip is this
rank's width block; a level whose block turns odd runs on the whole
width from there (``conv_down``), and s5 and s6, the maps the UNet's
cross-attention reads, come back whole (gathered once, summed
backward); s1..s4 stay width blocks.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.models.layers import (
    conv_down, conv_s2,
)
from music_style_transfer_ldm_tpu_torch.parallel.collectives import gather


class StyleEncoder(nn.Module):
    """[B, 1, 128, 128] -> dict of NCHW maps s1..s6."""

    def __init__(self, num_filters: int = 64):
        super().__init__()
        nf = num_filters
        chans = [(1, nf), (nf, nf * 2), (nf * 2, nf * 4), (nf * 4, nf * 4),
                 (nf * 4, nf * 4), (nf * 4, nf * 8)]
        for i, (ci, co) in enumerate(chans, 1):
            setattr(self, f"enc{i}", conv_s2(ci, co))

    def forward(self, style: torch.Tensor,
                ax=None) -> Dict[str, torch.Tensor]:
        out = {}
        x, sharded = style, True
        for i in range(1, 7):
            x, sharded = conv_down(getattr(self, f"enc{i}"), x, ax, sharded)
            x = torch.relu(x)
            out[f"s{i}"] = x
            if ax is not None and ax.sequence and sharded and i >= 5:
                out[f"s{i}"] = gather(x, -1, ax, summed=True)
        return out
