"""Spectrogram images from files.

Only ``load_image_unit`` is ported so far (the CLI reads style and
content PNGs with it); PNGs are decoded by ``utils/png.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from music_style_transfer_ldm_tpu_torch.utils.png import read_png_gray


def image_unit_from_gray(arr: np.ndarray, size: int = 128) -> np.ndarray:
    """uint8 [H, W] -> float32 [size, size, 1] in [0, 1]: crop from the
    top-left, zero-pad an undersized image."""
    arr = np.asarray(arr, np.uint8)[:size, :size]
    if arr.shape != (size, size):
        padded = np.zeros((size, size), np.uint8)
        padded[:arr.shape[0], :arr.shape[1]] = arr
        arr = padded
    return (arr.astype(np.float32) / 255.0)[..., None]


def load_image_unit(path: str | Path, size: int = 128) -> np.ndarray:
    """PNG -> float32 [size, size, 1] in [0, 1]."""
    return image_unit_from_gray(read_png_gray(Path(path).read_bytes()), size)
