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

The JAX package's orbax checkpoints are read where JAX is installed, by
``tools/convert_jax_checkpoint.py``, which writes these formats.

A model split over a model axis (``parallel/sharding.py shard_params``)
is written whole: with ``mesh=`` the savers gather every split tensor
(its parameters, BatchNorm statistics, EMA and Adam moments) over the
model group, so with a mesh every rank calls them, and they decide
who writes: the mesh's rank 0.
Such a file loads in one process and, through ``restore_train_state``
with a mesh, into any other mesh, which takes this rank's blocks of the
split tensors (Adam's moments included): what orbax's global arrays
give the JAX package.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path
from typing import Optional

import torch

from music_style_transfer_ldm_tpu_torch.parallel.collectives import is_main
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    gather_tensors, local_blocks, split_dims,
)
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


def _whole(module, mesh, tensors: Optional[dict] = None) -> dict:
    """``tensors`` (default ``module``'s state dict) by name, the ones
    ``module`` holds split gathered whole (with a mesh)."""
    tensors = module.state_dict() if tensors is None else tensors
    if mesh is None:
        return tensors
    return gather_tensors(tensors, split_dims(module), mesh)


def _opt_param_names(optimizer, module) -> list:
    """The name of each parameter of ``optimizer``, in its state dict's
    index order."""
    names = {id(p): k for k, p in module.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _opt_state(optimizer, module, mesh, whole: bool) -> dict:
    """``optimizer``'s state dict with the moments of split parameters
    gathered whole (``whole``), or cut to this rank's blocks."""
    sd = optimizer.state_dict()
    dims = split_dims(module) if mesh is not None else {}
    if not dims:
        return sd
    # the packed state's dicts are the optimizer's own: copy, then change
    sd = {**sd, "state": {i: dict(st) for i, st in sd["state"].items()}}
    names = _opt_param_names(optimizer, module)
    for i, st in sd["state"].items():
        name = names[int(i)]
        if name not in dims:
            continue
        moments = {k: v for k, v in st.items()
                   if isinstance(v, torch.Tensor) and v.ndim}
        fn = gather_tensors if whole else local_blocks
        st.update(fn(moments, {k: dims[name] for k in moments}, mesh))
    return sd


def save_checkpoint(path: str | Path, model, ema_params: Optional[dict] = None,
                    distill: Optional[dict] = None, mesh=None) -> None:
    """Write ``model``'s state (float32, on the CPU) and the optional EMA
    parameters and distillation metadata; with ``mesh``, every rank calls
    it and rank 0 writes the whole tensors."""
    params = _whole(model, mesh)
    ema = None if ema_params is None else _whole(model, mesh, ema_params)
    if mesh is not None and not is_main(mesh):
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": _cpu_state(params),
                "ema_params": None if ema is None else _cpu_state(ema),
                "distill": None if distill is None else dict(distill),
                "format_version": FORMAT_VERSION}, path)


def _load(path: str | Path, key: str) -> dict:
    """A payload of the port (tensors only, no pickled code) that holds
    ``key``, in the current format."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or key not in payload:
        raise ValueError(f"{path} is not a checkpoint of the port (no "
                         f"{key!r}); convert an orbax checkpoint of the JAX "
                         "package with tools/convert_jax_checkpoint.py")
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


def save_autoencoder(path: str | Path, encoder, decoder, mesh=None) -> None:
    """Write the encoder's and decoder's state (parameters and BatchNorm
    statistics, float32, on the CPU): the inputs of the LDM phase.  With
    ``mesh``, every rank calls it and rank 0 writes the whole tensors."""
    enc, dec = _whole(encoder, mesh), _whole(decoder, mesh)
    if mesh is not None and not is_main(mesh):
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": {"encoder": _cpu_state(enc),
                           "decoder": _cpu_state(dec)},
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
                     extra: Optional[dict] = None, mesh=None) -> None:
    """A checkpoint of the whole train state: ``load_ldm`` reads it as it
    reads any checkpoint, ``restore_train_state`` resumes from it.
    ``extra`` (plain numbers) rides along under the key ``extra``.  With
    ``mesh``, every rank calls it and rank 0 writes the whole tensors."""
    model = state.model
    params = _whole(model, mesh)
    ema = (None if state.ema_params is None
           else _whole(model, mesh, state.ema_params))
    opt = _opt_state(state.optimizer, model, mesh, whole=True)
    if mesh is not None and not is_main(mesh):
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"params": _cpu_state(params),
               "ema_params": None if ema is None else _cpu_state(ema),
               "distill": None,
               "opt_state": _cpu_tree(opt),
               "step": int(state.step),
               "format_version": FORMAT_VERSION}
    if extra:
        payload["extra"] = dict(extra)
    torch.save(payload, path)


def restore_train_state(path: str | Path, state: TrainState,
                        mesh=None) -> TrainState:
    """Load a train-state checkpoint into ``state``'s model and optimizer
    (in place) and return the state with its step and EMA.  A template
    that tracks an EMA but a checkpoint without one seeds the EMA from
    the restored weights.  With ``mesh``, a model split over its model
    axis takes this rank's blocks of the whole tensors, Adam's moments
    and the EMA included."""
    payload = load_checkpoint(path)
    if "opt_state" not in payload:
        raise ValueError(f"{path} holds no optimizer state: not a "
                         "train-state checkpoint")
    dims = split_dims(state.model) if mesh is not None else {}
    state.model.load_state_dict(local_blocks(payload["params"], dims, mesh)
                                if dims else payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    if dims:
        state.optimizer.load_state_dict(_opt_state(
            state.optimizer, state.model, mesh, whole=False))
    ema = None
    if state.ema_params is not None:
        if payload.get("ema_params") is not None:
            dev = next(iter(state.ema_params.values())).device
            saved = payload["ema_params"]
            if dims:
                saved = local_blocks(saved, dims, mesh)
            ema = {k: v.float().to(dev) for k, v in saved.items()}
        else:
            print(f"NOTE: checkpoint {path} has no ema_params; seeding the "
                  "EMA from the restored raw weights.", flush=True)
            ema = ema_params_of(state.model)
    return dataclasses.replace(state, step=int(payload["step"]),
                               ema_params=ema)
