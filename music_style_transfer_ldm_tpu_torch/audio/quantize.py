"""Unit image -> log-mel dB (the inverse of the uint8 image codec)."""

from __future__ import annotations

import torch


def unit_image_to_db(x: torch.Tensor, max_db: float = 80.0) -> torch.Tensor:
    """float [0, 1] -> dB in [-max_db, 0]."""
    return x.float() * max_db - max_db
