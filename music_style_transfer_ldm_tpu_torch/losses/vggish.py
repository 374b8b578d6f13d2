"""VGGish perceptual feature distance (the style loss).

The VGGish conv trunk (conv1 64, conv2 128, conv3_1/3_2 256, conv4_1/4_2
512; 2x2 max-pools after conv1, conv2, conv3_2 and conv4_2) gives six
post-ReLU feature maps per image.  The distance std-normalises each map
per sample (eps 1e-8, statistics in f32), takes the MSE and averages
over layers.  Public tensors are NHWC; the trunk runs NCHW inside.

Rounding follows the fused kernel: a conv multiplies dtype-rounded
operands in f32 (autocast and TF32 off), adds the f32 bias, rounds to
the module's dtype, then ReLU.  For float32 that is the plain conv.

``vggish_feature_distance`` implementations (``impl``):

* ``plain``: this trunk plus the plain ``normalized_mse`` (the JAX
  package's ``xla``);
* ``layer``: the trunk's convs here, kernel D per layer (the JAX
  package's ``pallas``), gradients to both inputs;
* ``fused`` / ``fused-value``: kernel E (``ops/fused_trunk.py``), the
  pred-side gradient / the value only; ``target`` gets a zero gradient;
* ``auto``: the plain version on the CPU; on the card ``layer`` when
  ``target`` needs a gradient, ``fused`` when only ``pred`` does,
  ``fused-value`` when neither does.  (The JAX package resolves ``auto``
  to ``xla``, from a TPU measurement that does not apply here.)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.ops.fused_trunk import (
    conv_relu, fused_supported, fused_vggish_distance,
    fused_vggish_distance_value,
)
from music_style_transfer_ldm_tpu_torch.ops.normalized_mse import (
    normalized_mse_kernel, normalized_mse_reference,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import exact_float32

# (layer name, out channels, followed by a pool)
VGGISH_CONVS = (
    ("conv1", 64, True),
    ("conv2", 128, True),
    ("conv3_1", 256, False),
    ("conv3_2", 256, True),
    ("conv4_1", 512, False),
    ("conv4_2", 512, True),
)
# torchvggish ``features`` Sequential indices of the convs, in order.
_TORCH_CONV_INDICES = (0, 3, 6, 8, 11, 13)
IMPLS = ("auto", "plain", "layer", "fused", "fused-value")

# The plain version of kernel D: one layer's loss with the closed-form
# backward.
normalized_mse = normalized_mse_reference


def flax_conv_init_(conv: nn.Conv2d) -> None:
    """flax's default Conv init: lecun-normal (truncated at 2 sigma)
    kernel, zero bias."""
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std, 2.0 * std)
        if conv.bias is not None:
            conv.bias.zero_()


class VGGishFeatures(nn.Module):
    """The VGGish conv trunk (frozen).  ``widths`` narrows it for tests;
    ``dtype`` is the compute dtype (weights stay f32)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 widths: Optional[Sequence[int]] = None):
        super().__init__()
        widths = widths or [c for _, c, _ in VGGISH_CONVS]
        cin = 1
        for (name, _, _), cout in zip(VGGISH_CONVS, widths):
            conv = nn.Conv2d(cin, cout, 3, padding=1)
            flax_conv_init_(conv)
            setattr(self, name, conv)
            cin = cout
        self.dtype = dtype
        self.requires_grad_(False)

    def layers(self) -> List[tuple]:
        """[(conv, followed by a pool)] in trunk order."""
        return [(getattr(self, name), pool) for name, _, pool in VGGISH_CONVS]

    def feature_maps(self, x: torch.Tensor, start: int = 0
                     ) -> List[torch.Tensor]:
        """The post-ReLU NCHW maps of convs ``start``..5, in ``dtype``, from
        x, the NCHW input of conv ``start``."""
        feats = []
        with exact_float32(x.device):
            for conv, pool in self.layers()[start:]:
                x = conv_relu(x, conv, self.dtype)
                feats.append(x)
                if pool and len(feats) + start < 6:
                    x = F.max_pool2d(x, 2)
        return feats

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NHWC [B, H, W, 1] -> the six post-ReLU maps, NHWC."""
        return [f.permute(0, 2, 3, 1)
                for f in self.feature_maps(x.permute(0, 3, 1, 2))]


def resolve_impl(module: VGGishFeatures, pred: torch.Tensor,
                 target: torch.Tensor, impl: str = "auto") -> str:
    """The implementation ``auto`` stands for at these inputs."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; one of {IMPLS}")
    if impl != "auto":
        return impl
    if pred.device.type == "cpu":
        return "plain"
    grad = torch.is_grad_enabled()
    if grad and target.requires_grad:
        return "layer"       # the fused kernel gives target no gradient
    if not fused_supported(module, pred):
        return "layer"
    return "fused" if grad and pred.requires_grad else "fused-value"


def vggish_feature_distance(module: VGGishFeatures, predicted: torch.Tensor,
                            target: torch.Tensor,
                            weights: Optional[torch.Tensor] = None,
                            impl: str = "auto") -> torch.Tensor:
    """Std-normalised multi-layer feature MSE of NHWC [B, H, W, 1] images,
    renormalised by the [B] validity ``weights`` (default ones); scalar
    f32.  Gradients reach the images, never the (frozen) trunk."""
    if weights is None:
        weights = torch.ones(predicted.shape[0], device=predicted.device)
    impl = resolve_impl(module, predicted, target, impl)
    if impl in ("fused", "fused-value"):
        fn = (fused_vggish_distance if impl == "fused"
              else fused_vggish_distance_value)
        return fn(module, predicted, target, weights)
    layer = normalized_mse_kernel if impl == "layer" else normalized_mse
    fp = module.feature_maps(predicted.permute(0, 3, 1, 2))
    ft = module.feature_maps(target.permute(0, 3, 1, 2))
    total = torch.zeros((), device=predicted.device)
    for p, t in zip(fp, ft):
        total = total + layer(p, t, weights)
    return total / len(fp)


class VGGishFeatureLoss:
    """The frozen VGGish distance as a callable, ``(predicted, target,
    weights=None) -> scalar f32`` on NHWC [B, H, W, 1] images; gradients
    reach the images, never the trunk.  ``params`` is a state dict of
    ``VGGishFeatures`` (``convert_torchvggish_state_dict`` makes one from
    torchvggish weights), else the trunk is a random init from ``seed``
    (``losses/feature.py build_feature_metric``).  It lives on
    ``device``, the card unless the caller asks for the CPU.
    ``input_shape`` keeps the JAX signature, whose flax module is
    initialised on an example input; a torch module needs none, so it
    changes nothing.  ``impl`` is ``vggish_feature_distance``'s."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, input_shape=(1, 128, 128, 1),
                 device="cuda", dtype: torch.dtype = torch.float32,
                 impl: str = "auto"):
        from music_style_transfer_ldm_tpu_torch.losses.feature import (
            build_feature_metric,   # imports this module
        )
        metric = build_feature_metric("vggish", dtype, seed, device, impl,
                                      params)
        self.module, self.impl = metric.module, impl

    def __call__(self, predicted: torch.Tensor, target: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        return vggish_feature_distance(self.module, predicted, target,
                                       weights, self.impl)


def convert_torchvggish_state_dict(state_dict: Dict[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """torchvggish ``vggish.features`` weights (``features.<i>.weight``,
    OIHW) -> a state dict of ``VGGishFeatures``."""
    out = {}
    for (name, _, _), idx in zip(VGGISH_CONVS, _TORCH_CONV_INDICES):
        for kind in ("weight", "bias"):
            out[f"{name}.{kind}"] = torch.as_tensor(
                state_dict[f"features.{idx}.{kind}"], dtype=torch.float32)
    return out
