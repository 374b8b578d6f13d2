"""Scalar training losses: f32 results of tensors in any layout.

The perceptual term takes its feature-distance callable explicitly
(``feature_loss(a, b, weights)``).  ``perceptual_loss`` and
``gram_matrix`` are the reference's own loss API, kept for callers
written against it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from music_style_transfer_ldm_tpu_torch.utils.chips import exact_float32


def weighted_batch_mean(per_elem: torch.Tensor,
                        weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean of elementwise values; with a [B] validity vector ``weights``
    the per-sample means are renormalised by it (the mean over the rows
    with weight 1)."""
    per_elem = per_elem.float()
    if weights is None:
        return per_elem.mean()
    per_sample = per_elem.reshape(per_elem.shape[0], -1).mean(1)
    w = weights.float()
    return (per_sample * w).sum() / w.sum()


def mse(a: torch.Tensor, b: torch.Tensor,
        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return weighted_batch_mean((a.float() - b.float()) ** 2, weights)


def kl_regularization_loss(latent: torch.Tensor,
                           weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """mean(0.5 (z^2 - 1 - log(z^2 + 1e-8))): pushes latent activations
    toward unit variance."""
    z2 = latent.float() ** 2
    return weighted_batch_mean(0.5 * (z2 - 1.0 - torch.log(z2 + 1e-8)),
                               weights)


def diffusion_loss(noise_pred: torch.Tensor, noise_target: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE(eps_hat, eps)."""
    return mse(noise_pred, noise_target, weights)


def compression_loss(original: torch.Tensor, reconstructed: torch.Tensor,
                     latent: torch.Tensor,
                     feature_loss: Optional[Callable] = None,
                     perceptual_weight: float = 0.1, kl_weight: float = 0.01,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE + perceptual_weight * feature_loss(original, reconstructed) +
    kl_weight * KL.  Note the argument order: the reconstruction is the
    feature loss's second (target) input."""
    loss = mse(reconstructed, original, weights)
    if feature_loss is not None:
        loss = loss + perceptual_weight * feature_loss(original,
                                                       reconstructed, weights)
    return loss + kl_weight * kl_regularization_loss(latent, weights)


def style_loss(reconstructed: torch.Tensor, style_spec: torch.Tensor,
               feature_loss: Callable,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Perceptual distance between the output and the style image."""
    return feature_loss(reconstructed, style_spec, weights)


def perceptual_loss(original: torch.Tensor, reconstructed: torch.Tensor,
                    feature_extractor_type: str = "vggish",
                    feature_extractor: Optional[Callable] = None
                    ) -> torch.Tensor:
    """The reference's dispatcher: ``"vggish"`` requires an extractor,
    called as ``feature_extractor(original, reconstructed)``; otherwise a
    given extractor is called the same way, and with none an
    ``LPIPSLoss(seed=0)`` is built once per device of ``original`` and
    kept for later calls (the reference built one per call)."""
    if feature_extractor_type == "vggish":
        if feature_extractor is None:
            raise ValueError("Feature extractor must be provided for VGGish")
        return feature_extractor(original, reconstructed)
    if feature_extractor is not None:
        return feature_extractor(original, reconstructed)
    from music_style_transfer_ldm_tpu_torch.losses.lpips import (
        LPIPSLoss,   # imports this module
    )
    device = original.device
    if device not in _DEFAULT_LPIPS:
        _DEFAULT_LPIPS[device] = LPIPSLoss(device=device)
    return _DEFAULT_LPIPS[device](original, reconstructed)


# perceptual_loss's LPIPS metrics, one per device, each built on its own
_DEFAULT_LPIPS: dict = {}


def gram_matrix(features: torch.Tensor) -> torch.Tensor:
    """The Gram matrix of NHWC features: [B, C, C] f32 divided by C*H*W
    (autocast off)."""
    B, H, W, C = features.shape
    f = features.reshape(B, H * W, C).float()
    with exact_float32(f.device):
        return torch.bmm(f.transpose(1, 2), f) / (C * H * W)
