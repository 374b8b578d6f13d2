"""Train state and its small helpers."""

from __future__ import annotations

import dataclasses
import functools
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
    away in bf16).  Elementwise, so on a model axis each rank keeps the
    EMA of its own parameter blocks."""
    s = np.float32(step)
    d = np.minimum(np.float32(decay),
                   (np.float32(1.0) + s) / (np.float32(10.0) + s))
    om = float(np.float32(1.0) - d)
    d = float(d)
    return {k: d * ema_params[k] + om * p.detach().float()
            for k, p in model.named_parameters()}


def count_params(module: nn.Module) -> int:
    return int(sum(p.numel() for p in module.parameters()))


@functools.lru_cache(maxsize=8)
def _unit_table(device: torch.device) -> torch.Tensor:
    """float32 k / 255 for k = 0..255, divided on the host and kept on
    ``device``."""
    return (torch.arange(256, dtype=torch.float32) / 255.0).to(device)


def as_unit_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches become unit floats, each value k / 255 correctly
    rounded, bit for bit what the host loaders' float32 division gives
    (a table: on the card, dividing by a Python number multiplies by its
    reciprocal, which is one ulp off for some k); float batches pass."""
    if not x.is_floating_point():
        return _unit_table(x.device)[x.long()]
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


def to_device(x, device: torch.device) -> torch.Tensor:
    """A batch on ``device``: a tensor already there passes untouched; a
    host array (or CPU tensor) goes through pinned memory with a
    non-blocking copy to a card."""
    if isinstance(x, torch.Tensor):
        if x.device.type == device.type and device.index in (
                None, x.device.index):
            return x
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
