"""The port's checkpoint format.

One ``torch.save`` file holding

    {"params": state_dict, "ema_params": state_dict | None,
     "distill": dict | None, "format_version": 2}

and, written by training (``save_train_state``), also ``opt_state`` (the
optimizer's state dict) and ``step``, so a run resumes where it stopped
(distillation's in-flight saves add their stage's identity as
``extra``);
with the keys of the JAX package's checkpoint payload: ``params`` is the
model's whole state dict (BatchNorm statistics included; the LDM's, or
the autoencoder trainer's encoder and decoder), ``ema_params``
an exponential moving average of its parameters when training kept one
(inference prefers it), and ``distill`` a progressively distilled
student's grid ({"steps", "t_max", "stages", "guidance"}).  Format 2 is
the JAX package's current one (transpose convs in PyTorch's geometry).

Two more kinds of file, each with ``format_version``:

* the autoencoder checkpoint (``save_autoencoder``; phase 1's
  ``pretrained.pt``, phase 2's ``--pretrained-ae``):
  ``{"params": {"encoder": state_dict, "decoder": state_dict}}``;
* the feature checkpoint (``save_feature_checkpoint``; ``import-torch
  --vggish|--lpips``, read by ``train --style-features|
  --compression-features``): ``{"kind": "vggish"|"lpips", "params":
  state_dict}`` of ``losses/vggish.py``'s or ``losses/lpips.py``'s module.

The JAX package's orbax checkpoints are not readable here: that needs
JAX, and waits for an offline converter.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Optional

import torch

from music_style_transfer_ldm_tpu_torch.training.state import (
    TrainState, ema_params_of,
)

FORMAT_VERSION = 2
# What reading a missing, truncated or foreign file can raise.
LOAD_ERRORS = (OSError, EOFError, ValueError, RuntimeError,
               pickle.UnpicklingError)


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


def _load(path: str | Path, key: str) -> dict:
    """A payload of the port (tensors only, no pickled code) that holds
    ``key``, in the current format."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or key not in payload:
        raise ValueError(f"{path} is not a checkpoint of the port (no "
                         f"{key!r}); orbax checkpoints of the JAX package "
                         "are not readable yet")
    _check_version(payload, path)
    return payload


def _check_version(payload: dict, path) -> None:
    version = int(payload.get("format_version", 0))
    if version != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {version}, expected "
                         f"{FORMAT_VERSION}")


def load_checkpoint(path: str | Path) -> dict:
    """Read a checkpoint written by ``save_checkpoint`` or
    ``save_train_state``."""
    return _load(path, "params")


def save_autoencoder(path: str | Path, encoder, decoder) -> None:
    """Write the encoder's and decoder's state (parameters and BatchNorm
    statistics, float32, on the CPU): the inputs of the LDM phase."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": {"encoder": _cpu_state(encoder.state_dict()),
                           "decoder": _cpu_state(decoder.state_dict())},
                "format_version": FORMAT_VERSION}, path)


def load_autoencoder(path: str | Path) -> dict:
    """-> {"params": {"encoder": state_dict, "decoder": state_dict},
    "format_version": 2}, as ``save_autoencoder`` wrote it."""
    payload = _load(path, "params")
    if set(payload["params"]) != {"encoder", "decoder"}:
        raise ValueError(f"{path} is not an autoencoder checkpoint (its "
                         "params are not {'encoder', 'decoder'})")
    return payload


def save_feature_checkpoint(path: str | Path, kind: str,
                            params: dict) -> None:
    """Write a feature metric's weights (a state dict of ``VGGishFeatures``
    or ``LPIPS``) under its kind."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"kind": kind, "params": _cpu_state(params),
                "format_version": FORMAT_VERSION}, path)


def load_feature_checkpoint(path: str | Path) -> dict:
    """-> {"kind", "params", "format_version"}, as
    ``save_feature_checkpoint`` wrote it."""
    return _load(path, "kind")


def save_train_state(path: str | Path, state: TrainState,
                     extra: Optional[dict] = None) -> None:
    """A checkpoint of the whole train state: ``load_ldm`` reads it as it
    reads any checkpoint, ``restore_train_state`` resumes from it.
    ``extra`` (plain numbers) rides along under the key ``extra``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"params": _cpu_state(state.model.state_dict()),
               "ema_params": (None if state.ema_params is None
                              else _cpu_state(state.ema_params)),
               "distill": None,
               "opt_state": _cpu_tree(state.optimizer.state_dict()),
               "step": int(state.step),
               "format_version": FORMAT_VERSION}
    if extra:
        payload["extra"] = dict(extra)
    torch.save(payload, path)


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
