"""The port's checkpoint format.

One ``torch.save`` file holding

    {"params": state_dict, "ema_params": state_dict | None,
     "distill": dict | None, "format_version": 2}

and, written by training (``save_train_state``), also ``opt_state`` (the
optimizer's state dict) and ``step``, so a run resumes where it stopped.

with the keys of the JAX package's checkpoint payload: ``params`` is the
LDM's whole state dict (BatchNorm statistics included), ``ema_params``
an exponential moving average of its parameters when training kept one
(inference prefers it), and ``distill`` a progressively distilled
student's grid ({"steps", "t_max", "stages", "guidance"}).  Format 2 is
the JAX package's current one (transpose convs in PyTorch's geometry).

The JAX package's orbax checkpoints are not readable here: that needs
JAX, and waits for an offline converter.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import torch

from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, ema_params_of,
)

FORMAT_VERSION = 2


def _cpu_state(state: dict) -> dict:
    return {k: v.detach().float().cpu() if v.is_floating_point()
            else v.detach().cpu() for k, v in state.items()}


def _cpu_tree(tree):
    """Every tensor of a nested dict/list on the CPU (dtype kept)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu_tree(v) for v in tree)
    return tree


def save_checkpoint(path: str | Path, model, ema_params: Optional[dict] = None,
                    distill: Optional[dict] = None) -> None:
    """Write ``model``'s state (float32, on the CPU) and the optional EMA
    parameters and distillation metadata."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": _cpu_state(model.state_dict()),
                "ema_params": (None if ema_params is None
                               else _cpu_state(ema_params)),
                "distill": None if distill is None else dict(distill),
                "format_version": FORMAT_VERSION}, path)


def load_checkpoint(path: str | Path) -> dict:
    """Read a checkpoint written by ``save_checkpoint`` (tensors only, no
    pickled code)."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a checkpoint of the port (no "
                         "'params'); orbax checkpoints of the JAX package "
                         "are not readable yet")
    version = int(payload.get("format_version", 0))
    if version != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {version}, expected "
                         f"{FORMAT_VERSION}")
    return payload


def save_train_state(path: str | Path, state: TrainState) -> None:
    """A checkpoint of the whole train state: ``load_ldm`` reads it as it
    reads any checkpoint, ``restore_train_state`` resumes from it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": _cpu_state(state.model.state_dict()),
                "ema_params": (None if state.ema_params is None
                               else _cpu_state(state.ema_params)),
                "distill": None,
                "opt_state": _cpu_tree(state.optimizer.state_dict()),
                "step": int(state.step),
                "format_version": FORMAT_VERSION}, path)


def restore_train_state(path: str | Path, state: TrainState) -> TrainState:
    """Load a train-state checkpoint into ``state``'s model and optimizer
    (in place) and return the state with its step and EMA.  A template
    that tracks an EMA but a checkpoint without one seeds the EMA from
    the restored weights."""
    payload = load_checkpoint(path)
    if "opt_state" not in payload:
        raise ValueError(f"{path} holds no optimizer state: not a "
                         "train-state checkpoint")
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    ema = None
    if state.ema_params is not None:
        if payload.get("ema_params") is not None:
            dev = next(iter(state.ema_params.values())).device
            ema = {k: v.float().to(dev)
                   for k, v in payload["ema_params"].items()}
        else:
            print(f"NOTE: checkpoint {path} has no ema_params; seeding the "
                  "EMA from the restored raw weights.", flush=True)
            ema = ema_params_of(state.model)
    return dataclasses.replace(state, step=int(payload["step"]),
                               ema_params=ema)
