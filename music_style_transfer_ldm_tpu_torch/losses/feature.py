"""Feature-metric factory used by the trainers.

The compression loss's perceptual term uses the configured extractor
(default ``lpips``) and its gradient flows.  The style loss always uses
VGGish; with ``TrainConfig.style_loss_stop_gradient`` (the default) the
trainer computes it without a gradient.  A metric is a fixed-seed random
trunk unless it is given transplanted weights: a state dict of its
module, as ``losses/vggish.py``'s and ``losses/lpips.py``'s converters
make it from the reference's PyTorch weights (``cli import-torch
--vggish|--lpips``; ``train --style-features|--compression-features``).
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
                         seed: int = 0, device="cuda", impl: str = "auto",
                         params: Optional[dict] = None) -> FeatureMetric:
    """A frozen metric on ``device`` (the card unless the caller asks for
    the CPU): its weights are ``params`` (a state dict of the module,
    loaded strictly) when given, else a random init from ``seed``."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if kind == "lpips":
            module = LPIPS(dtype=dtype)
        elif kind == "vggish":
            module = VGGishFeatures(dtype=dtype)
        else:
            raise ValueError(f"unknown feature extractor {kind!r}")
    if params is not None:
        module.load_state_dict(params)
    return FeatureMetric(kind, module.to(device).eval(), impl)
