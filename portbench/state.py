"""What the drivers share: seeded images, the limits of a cell, the
program's model from the benchmark's weights, the device's record, and
freeing the program before the reference runs."""

from __future__ import annotations

import gc

import numpy as np
import torch


def image_pool(n: int, size: int, rng: np.random.Generator) -> np.ndarray:
    """[n, size, size, 1] unit images on the uint8 grid: a smooth random
    field (8x8 blocks, bilinear) plus fine noise."""
    coarse = rng.random((n, 1, size // 8, size // 8), dtype=np.float32)
    smooth = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(size, size), mode="bilinear",
        align_corners=False).numpy()
    img = 0.8 * smooth + 0.2 * rng.random((n, 1, size, size),
                                          dtype=np.float32)
    u8 = np.floor(np.clip(img, 0.0, 1.0) * 255.0 + 0.5)
    return (u8 / np.float32(255.0)).astype(np.float32).transpose(0, 2, 3, 1)


def limits(cell) -> dict:
    """The limits of the cell's compared numbers: the mix's own
    (``limits``), else the configuration's group named by the mix's
    ``kind``."""
    if "limits" in cell.traffic:
        return cell.traffic["limits"]
    return cell.config["limits"][cell.traffic["kind"]]


def make_ldm(model: dict, weights: dict, dtype: torch.dtype, device):
    """The program's ``LDM`` built on ``device`` with ``weights`` (the
    reference's names, checked whole by a strict load), in ``dtype``,
    frozen and in eval mode, as ``load_ldm`` returns it."""
    from music_style_transfer_ldm_tpu_torch.models.ldm import LDM
    with torch.device(device):
        ldm = LDM(latent_dim=model["latent_dim"],
                  num_timesteps=model["num_timesteps"],
                  beta_start=model["beta_start"], beta_end=model["beta_end"],
                  unet_num_filters=model["unet_num_filters"],
                  style_num_filters=model["style_num_filters"])
    ldm.load_state_dict(weights)
    ldm.requires_grad_(False)
    return ldm.to(dtype=dtype).eval()


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    torch.cuda.synchronize(dev)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def release(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
