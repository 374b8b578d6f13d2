"""Model diagnostics and audio-fidelity metrics.

Library forms of the reference's run-by-hand checks: the parameter-count
table, the dead-style-encoder probe (embedding std across distinct
styles), autoencoder reconstruction grids and LDM forward panels (PNGs
through ``utils/png.py``; no Pillow), plus spectral convergence and the
mean log-mel dB distance of two clips.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from music_style_transfer_ldm_tpu_torch.audio.mel import (
    melspectrogram, power_to_db,
)
from music_style_transfer_ldm_tpu_torch.audio.quantize import (
    unit_image_to_uint8,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device
from music_style_transfer_ldm_tpu_torch.utils.png import write_png_gray


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _u8(img01: np.ndarray) -> np.ndarray:
    return unit_image_to_uint8(torch.as_tensor(img01)).numpy()


def _write_png(path, img_u8: np.ndarray) -> None:
    Path(path).write_bytes(write_png_gray(img_u8))


# The LDM's components, in the order of the JAX package's table (a
# params tree's keys, sorted).
COMPONENTS = ("decoder", "encoder", "style_encoder", "unet")


def parameter_table(model: nn.Module) -> Dict[str, int]:
    """Parameter counts per component of the LDM and their total, keyed
    and ordered as the JAX package's table."""
    table = {name: int(sum(p.numel()
                           for p in getattr(model, name).parameters()))
             for name in COMPONENTS}
    table["total"] = sum(table.values())
    return table


def style_embedding_stats(embeddings: Dict[str, torch.Tensor]
                          ) -> Dict[str, Dict[str, float]]:
    """Mean / std / zero fraction per pyramid level."""
    out = {}
    for k, v in embeddings.items():
        v = _np32(v)
        out[k] = {"mean": float(v.mean()), "std": float(v.std()),
                  "zero_fraction": float((v == 0).mean())}
    return out


def detect_dead_style_encoder(embeddings: Dict[str, torch.Tensor],
                              std_threshold: float = 1e-4
                              ) -> Dict[str, bool]:
    """True per level whose embedding has (near-)zero spread across a
    batch of distinct styles: the reference's dead-encoder probe."""
    stats = style_embedding_stats(embeddings)
    return {k: s["std"] < std_threshold for k, s in stats.items()}


def reconstruction_grid(originals, reconstructions,
                        out_path: Optional[str] = None,
                        max_items: int = 8) -> np.ndarray:
    """Originals beside their reconstructions ([N, H, W, 1] in [0, 1]),
    one row per item, as a uint8 grid; a PNG too when out_path is
    given."""
    n = min(max_items, originals.shape[0])
    o = _np32(originals)[:n, :, :, 0]
    r = _np32(reconstructions)[:n, :, :, 0]
    grid = np.concatenate([np.concatenate([o[i], r[i]], axis=1)
                           for i in range(n)], axis=0)
    grid_u8 = _u8(grid)
    if out_path:
        _write_png(out_path, grid_u8)
    return grid_u8


def forward_visualization(outputs: Dict[str, torch.Tensor],
                          out_path: Optional[str] = None
                          ) -> Dict[str, float]:
    """Ranges of an LDM training forward's tensors (``LDM.forward``'s
    NHWC outputs); with out_path, a PNG of the first reconstruction."""
    summary = {}
    for k in ("z_t", "noise", "noise_pred", "z_0", "reconstructed"):
        v = _np32(outputs[k])
        summary[f"{k}_min"] = float(v.min())
        summary[f"{k}_max"] = float(v.max())
        summary[f"{k}_std"] = float(v.std())
    if out_path:
        _write_png(out_path, _u8(_np32(outputs["reconstructed"])[0, :, :, 0]))
    return summary


def _resize_nearest(x: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour upsample of a small 2-D map to size x size."""
    ry = np.linspace(0, x.shape[0] - 1, size).round().astype(int)
    rx = np.linspace(0, x.shape[1] - 1, size).round().astype(int)
    return x[np.ix_(ry, rx)]


def ldm_forward_panel(outputs: Dict[str, torch.Tensor], content, style,
                      out_path: str, item: int = 0) -> None:
    """A PNG strip of one LDM forward: content | style | z_t's first
    channel (min-max scaled, upsampled) | the reconstruction."""
    def norm01(x):
        lo, hi = x.min(), x.max()
        return (x - lo) / (hi - lo + 1e-8)

    content, style = _np32(content), _np32(style)
    h = content.shape[1]
    panels = [content[item, :, :, 0], style[item, :, :, 0],
              _resize_nearest(norm01(_np32(outputs["z_t"])[item, :, :, 0]),
                              h),
              _np32(outputs["reconstructed"])[item, :, :, 0]]
    strip = np.concatenate([np.clip(p, 0, 1) for p in panels], axis=1)
    _write_png(out_path, _u8(strip))


# ---------------- numeric fidelity metrics ---------------------------------


def spectral_convergence(target_mag, got_mag, device="cuda") -> float:
    """||got - target||_F / ||target||_F over magnitude spectrograms."""
    dev = resolve_device(device)
    t = torch.as_tensor(_np32(target_mag), device=dev)
    g = torch.as_tensor(_np32(got_mag), device=dev)
    return float(torch.linalg.vector_norm(g - t)
                 / (torch.linalg.vector_norm(t) + 1e-12))


def mel_db_distance(audio_a, audio_b, sr: int = 22050, n_mels: int = 128,
                    device="cuda") -> float:
    """Mean |dB| distance between two clips' log-mel spectrograms: the
    numeric form of the reference's listen-and-look evaluation."""
    dev = resolve_device(device)
    a, b = (power_to_db(melspectrogram(
        torch.as_tensor(_np32(x), device=dev), sr=sr, n_mels=n_mels))
        for x in (audio_a, audio_b))
    return float(torch.abs(a - b).mean())
