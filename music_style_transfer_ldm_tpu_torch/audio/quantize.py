"""Log-mel dB <-> grayscale image quantization (the uint8 image codec).

  u8 = floor(clip((db + max_db) * 255/max_db, 0, 255) + 0.5)
  db = u8 * (max_db/255) - max_db

plus the float forms that map straight to the [0, 1] images the models
take: with quantize=True a unit image is u8 / 255, bit-identical to a
PNG round trip.
"""

from __future__ import annotations

import torch


def db_to_uint8_image(S_db: torch.Tensor, max_db: float = 80.0
                      ) -> torch.Tensor:
    """dB in [-max_db, 0] -> uint8 [0, 255] with the +0.5 rounding."""
    x = (S_db.float() + max_db) * (255.0 / max_db)
    x = torch.clamp(x, 0.0, 255.0)
    return torch.floor(x + 0.5).to(torch.uint8)


def uint8_image_to_db(img: torch.Tensor, max_db: float = 80.0
                      ) -> torch.Tensor:
    """uint8 [0, 255] -> dB."""
    return img.float() * (max_db / 255.0) - max_db


def db_to_unit_image(S_db: torch.Tensor, max_db: float = 80.0,
                     quantize: bool = True) -> torch.Tensor:
    """dB -> float [0, 1], through the uint8 grid unless quantize=False."""
    if quantize:
        return db_to_uint8_image(S_db, max_db).float() / 255.0
    return torch.clamp((S_db.float() + max_db) / max_db, 0.0, 1.0)


def unit_image_to_db(x: torch.Tensor, max_db: float = 80.0) -> torch.Tensor:
    """float [0, 1] -> dB in [-max_db, 0]."""
    return x.float() * max_db - max_db


def unit_image_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float [0, 1] image -> uint8 with the same +0.5 rounding."""
    arr = torch.clamp(torch.as_tensor(x).float() * 255.0 + 0.5, 0.0, 255.0)
    return torch.floor(arr).to(torch.uint8)
