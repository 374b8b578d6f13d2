"""The two phases' optimizers and their plateau learning-rate control.

* ``adamw`` (the autoencoder phase): ``torch.optim.AdamW`` with betas
  0.9/0.999, eps 1e-8 and weight decay 0.01.  optax's ``adamw`` steps
  p - lr (m_hat / (sqrt(v_hat) + eps) + wd p); torch's decays first,
  p (1 - lr wd), then subtracts lr m_hat / (sqrt(v_hat) + eps) with the
  same p, which is the same update (held to optax by the tests).
* ``adam`` (the LDM phase): lr 5e-4, betas 0.9/0.999, eps 1e-8 (optax
  ``adam``'s update and bias correction) over every parameter outside
  the encoder; the encoder is frozen (``requires_grad=False``) and is
  not given to the optimizer, which leaves it exactly where optax's
  ``set_to_zero`` branch does.

``PlateauState`` is ReduceLROnPlateau (mode 'min') on the host; a new
rate goes into the optimizer's param groups between epochs.

On a model axis (``parallel/sharding.py``) each rank's optimizer holds
its parameters' blocks, and Adam's and AdamW's updates are elementwise,
so they need nothing of the other blocks; the replicated parameters
step alike on every peer because every peer takes model index 0's
gradients for them first (``sharding.sync_replicated``).  The only global
quantity the loop reads, the plateau metric, is the epoch's mean loss,
averaged over every rank (``collectives.all_reduce_mean``), so every
peer gets the same bits and takes the same decision; no gradient norm
is taken.
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


def make_optimizer(kind: str, params, learning_rate: float = 5e-4,
                   weight_decay: float = 0.01) -> torch.optim.Optimizer:
    """'adamw' (the autoencoder phase; ``weight_decay`` applies to it
    only) or 'adam' (the LDM phase)."""
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    if kind == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8)
    raise ValueError(f"unknown optimizer {kind!r}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
