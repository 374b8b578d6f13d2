"""LPIPS perceptual distance (AlexNet backbone), the compression loss's
default perceptual term.

AlexNet conv features at relu1..relu5 (3x3/2 max-pools before conv2 and
conv3), each unit-normalised over channels (+1e-10), squared difference,
a 1x1 linear head per layer, spatial mean, sum over layers.  Grayscale
inputs are replicated to 3 channels and shifted from [0, 1] to [-1, 1].
Plain PyTorch (the JAX package's LPIPS has no TPU kernel).  Without
pretrained weights the trunk is a fixed-seed random init with flax's
defaults; ``convert_torch_lpips_state_dict`` carries a torch ``lpips``
state dict over.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.losses.basic import (
    weighted_batch_mean,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import flax_conv_init_

# (name, out channels, kernel, stride, padding, max-pool before)
ALEX_CONVS = (
    ("conv1", 64, 11, 4, 2, False),
    ("conv2", 192, 5, 1, 2, True),
    ("conv3", 384, 3, 1, 1, True),
    ("conv4", 256, 3, 1, 1, False),
    ("conv5", 256, 3, 1, 1, False),
)


class AlexNetFeatures(nn.Module):
    """AlexNet conv trunk returning the five post-ReLU maps (NCHW)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for name, ch, k, s, p, _ in ALEX_CONVS:
            conv = nn.Conv2d(cin, ch, k, stride=s, padding=p)
            flax_conv_init_(conv)
            setattr(self, name, conv)
            cin = ch

    def forward(self, x: torch.Tensor, dtype: torch.dtype
                ) -> List[torch.Tensor]:
        feats = []
        x = x.to(dtype)
        for name, *_, pool in ALEX_CONVS:
            if pool:
                x = F.max_pool2d(x, 3, 2)
            conv = getattr(self, name)
            x = torch.relu(F.conv2d(x, conv.weight.to(dtype),
                                    conv.bias.to(dtype), conv.stride,
                                    conv.padding))
            feats.append(x)
        return feats


class LPIPS(nn.Module):
    """Frozen LPIPS head over NHWC [B, H, W, 1 or 3] images in [0, 1];
    ``dtype`` is the compute dtype of the trunk and heads."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.alex = AlexNetFeatures()
        for i, (_, ch, *_) in enumerate(ALEX_CONVS):
            head = nn.Conv2d(ch, 1, 1, bias=False)
            with torch.no_grad():
                head.weight.uniform_(0.0, 0.1)   # flax uniform(scale=0.1)
            setattr(self, f"lin{i}", head)
        self.requires_grad_(False)

    def forward(self, a: torch.Tensor, b: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        def prep(x):
            x = x.float().permute(0, 3, 1, 2)
            if x.shape[1] == 1:
                x = x.repeat(1, 3, 1, 1)
            return 2.0 * x - 1.0

        dt = self.dtype
        fa = self.alex(prep(a), dt)
        fb = self.alex(prep(b), dt)
        total = torch.zeros((), device=a.device)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True)
                       + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True)
                       + 1e-10)
            head = getattr(self, f"lin{i}")
            d = F.conv2d(((na - nb) ** 2).to(dt), head.weight.to(dt))
            total = total + weighted_batch_mean(d.float(), weights)
        return total


class LPIPSLoss:
    """A frozen ``LPIPS`` as a callable, ``(a, b, weights=None) -> scalar
    f32``.  ``params`` is a state dict of ``LPIPS``
    (``convert_torch_lpips_state_dict``), else a random init from
    ``seed``; on ``device``, the card unless the caller asks for the CPU.
    ``input_shape`` keeps the JAX signature and changes nothing (a torch
    module needs no example input)."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, input_shape=(1, 128, 128, 1),
                 device="cuda"):
        from music_style_transfer_ldm_tpu_torch.losses.feature import (
            build_feature_metric,   # imports this module
        )
        self.module = build_feature_metric("lpips", seed=seed, device=device,
                                           params=params).module

    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.module(a, b, weights)


def convert_torch_lpips_state_dict(state_dict: Dict[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """A torch ``lpips.LPIPS(net='alex')`` state dict (``net.sliceK.i``
    convs, ``linK.model.1`` heads) -> a state dict of ``LPIPS``."""
    conv_keys = (("conv1", "net.slice1.0"), ("conv2", "net.slice2.3"),
                 ("conv3", "net.slice3.6"), ("conv4", "net.slice4.8"),
                 ("conv5", "net.slice5.10"))
    out = {}
    for name, key in conv_keys:
        for kind in ("weight", "bias"):
            out[f"alex.{name}.{kind}"] = torch.as_tensor(
                state_dict[f"{key}.{kind}"], dtype=torch.float32)
    for i in range(len(ALEX_CONVS)):
        out[f"lin{i}.weight"] = torch.as_tensor(
            state_dict[f"lin{i}.model.1.weight"], dtype=torch.float32)
    return out
