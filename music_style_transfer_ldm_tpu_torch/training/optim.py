"""The LDM phase's optimizer and its plateau learning-rate control.

Adam (lr 5e-4, betas 0.9/0.999, eps 1e-8: optax ``adam``'s update and
bias correction) over every parameter outside the encoder; the encoder
is frozen (``requires_grad=False``) and is not given to the optimizer,
which leaves it exactly where optax's ``set_to_zero`` branch does.
``PlateauState`` is ReduceLROnPlateau (mode 'min') on the host; a new
rate goes into the optimizer's param groups between epochs.  AdamW for
the autoencoder phase is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn


@dataclasses.dataclass
class PlateauState:
    """ReduceLROnPlateau bookkeeping (torch semantics, mode='min')."""

    lr: float
    factor: float = 0.5
    patience: int = 5
    min_lr: float = 1e-6
    best: float = float("inf")
    bad_epochs: int = 0


def plateau_init(lr: float, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-6) -> PlateauState:
    return PlateauState(lr=lr, factor=factor, patience=patience,
                        min_lr=min_lr)


def plateau_update(state: PlateauState, metric: float) -> PlateauState:
    """One scheduler.step(metric): the updated state (new .lr)."""
    s = dataclasses.replace(state)
    if metric < s.best:
        s.best = metric
        s.bad_epochs = 0
    else:
        s.bad_epochs += 1
        if s.bad_epochs > s.patience:
            s.lr = max(s.lr * s.factor, s.min_lr)
            s.bad_epochs = 0
    return s


def freeze_encoder(model: nn.Module) -> List[nn.Parameter]:
    """Make every parameter trainable except the encoder's; returns the
    trainable ones in ``named_parameters`` order."""
    model.requires_grad_(True)
    model.encoder.requires_grad_(False)
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(kind: str, params, learning_rate: float = 5e-4
                   ) -> torch.optim.Optimizer:
    """'adam' (the LDM phase)."""
    if kind != "adam":
        raise ValueError(f"optimizer {kind!r} is not ported yet (adam only)")
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
