"""Train state and its small helpers."""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    """What a training step changes: the model (parameters and BatchNorm
    statistics, in place), the optimizer, the step count and, when EMA
    tracking is on, the f32 moving average of the parameters by name."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def ema_params_of(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A fresh f32 copy of every parameter, by name."""
    return {k: p.detach().float().clone()
            for k, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], model: nn.Module,
               decay: float, step: int) -> Dict[str, torch.Tensor]:
    """ema <- d ema + (1 - d) params with the warm-up d = min(decay,
    (1 + step) / (10 + step)), accumulated in f32 (a 0.999 step rounds
    away in bf16)."""
    s = np.float32(step)
    d = np.minimum(np.float32(decay),
                   (np.float32(1.0) + s) / (np.float32(10.0) + s))
    om = float(np.float32(1.0) - d)
    d = float(d)
    return {k: d * ema_params[k] + om * p.detach().float()
            for k, p in model.named_parameters()}


def count_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


def as_unit_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches become unit floats (x / 255); float batches pass."""
    if not x.is_floating_point():
        return x.float() / 255.0
    return x


def prefetch_to_device(batches: Iterable, place_fn: Callable,
                       depth: int = 2):
    """Keep ``depth`` placed batches in flight, so a batch's host-to-card
    copy (pinned memory, non_blocking in ``place_fn``) overlaps the steps
    before it."""
    buf: deque = deque()
    for item in batches:
        buf.append(place_fn(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: through pinned memory with a
    non-blocking copy to a card."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
