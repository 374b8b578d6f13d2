"""Feature-metric factory used by the trainer.

The compression loss's perceptual term uses the configured extractor
(default ``lpips``) and its gradient flows.  The style loss always uses
VGGish; with ``TrainConfig.style_loss_stop_gradient`` (the default) the
trainer computes it without a gradient.  Both metrics are fixed-seed
random trunks; transplanted weights (``losses/vggish.py``'s and
``losses/lpips.py``'s converters) are not wired to training yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.losses.lpips import LPIPS
from music_style_transfer_ldm_tpu_torch.losses.vggish import (
    VGGishFeatures, vggish_feature_distance,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device


@dataclasses.dataclass
class FeatureMetric:
    kind: str
    module: nn.Module
    impl: str = "auto"   # vggish layer implementation (losses/vggish.py)

    def distance(self, a: torch.Tensor, b: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scalar f32 distance of NHWC image batches a and b."""
        if self.kind == "lpips":
            return self.module(a, b, weights)
        return vggish_feature_distance(self.module, a, b, weights,
                                       impl=self.impl)


def build_feature_metric(kind: str, dtype: torch.dtype = torch.float32,
                         seed: int = 0, device="cuda",
                         impl: str = "auto") -> FeatureMetric:
    """A frozen metric whose random init comes from ``seed``, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if kind == "lpips":
            module = LPIPS(dtype=dtype)
        elif kind == "vggish":
            module = VGGishFeatures(dtype=dtype)
        else:
            raise ValueError(f"unknown feature extractor {kind!r}")
    return FeatureMetric(kind, module.to(device).eval(), impl)
