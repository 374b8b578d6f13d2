"""Carry the JAX package's flax variables into the port's modules.

Input is the flax variable tree as nested dicts of numpy arrays,
``{'params': ..., 'batch_stats': ...}`` (for example
``jax.tree_util.tree_map(np.asarray, variables)`` on the JAX side); no
JAX import is needed here.  Mappings:

* Conv          kernel [kh, kw, I, O] -> weight [O, I, kh, kw]
* ConvTranspose kernel [kh, kw, I, O] -> flip kh and kw, then
                weight [I, O, kh, kw]
* Dense         kernel [I, O]         -> weight [O, I]
* attention     q/k/v/out_proj stay four separate Linears
* BatchNorm     scale/bias, mean/var  -> weight/bias,
                running_mean/running_var

``export_flax_variables`` is the inverse.  ``load_flax_convs`` and
``export_flax_convs`` do the same for a frozen feature network (the
VGGish trunk, ``{conv1..conv4_2: kernel, bias}``; LPIPS,
``{alex: {conv1..conv5}, lin0..lin4}``): every Conv2d of the module at
its dotted name's path in the tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

_BN = (("scale", "weight"), ("bias", "bias"))
_STATS = (("mean", "running_mean"), ("var", "running_var"))


def _conv_to_torch(k: np.ndarray, transpose: bool) -> np.ndarray:
    if transpose:
        return np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(k.transpose(3, 2, 0, 1))


def _conv_to_flax(w: np.ndarray, transpose: bool) -> np.ndarray:
    if transpose:
        return np.ascontiguousarray(w.transpose(2, 3, 0, 1)[::-1, ::-1])
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _layers(ldm) -> Iterator[Tuple[str, str, nn.Module]]:
    """(component, flax name, torch module) for every parameterised layer
    of the components that ``ldm`` has (the LDM's four, or the
    autoencoder trainer's encoder and decoder)."""
    for comp in ("encoder", "decoder", "unet", "style_encoder"):
        module = getattr(ldm, comp, None)
        if module is None:
            continue
        for name, child in module.named_children():
            if isinstance(child, (nn.Conv2d, nn.ConvTranspose2d,
                                  nn.BatchNorm2d, nn.Linear)):
                yield comp, name, child
            else:  # CrossAttention: four Linears
                for sub, lin in child.named_children():
                    yield comp, f"{name}/{sub}", lin


def _get(tree: Dict[str, Any], path: str) -> Dict[str, Any]:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _set(tree: Dict[str, Any], path: str, value: Dict[str, Any]) -> None:
    keys = path.split("/")
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


@torch.no_grad()
def load_flax_variables(ldm, variables: Dict[str, Any]) -> None:
    """Fill ``ldm`` (the port's LDM, or a module with its ``encoder`` and
    ``decoder``) in place from flax variables."""
    params, stats = variables["params"], variables.get("batch_stats", {})

    def put(t: torch.Tensor, a) -> None:
        a = np.asarray(a, np.float32)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"shape {a.shape} does not fit {tuple(t.shape)}")
        t.copy_(torch.tensor(a))

    for comp, name, mod in _layers(ldm):
        p = _get(params[comp], name)
        if isinstance(mod, nn.BatchNorm2d):
            for src, dst in _BN:
                put(getattr(mod, dst), p[src])
            s = _get(stats[comp], name)
            for src, dst in _STATS:
                put(getattr(mod, dst), s[src])
        elif isinstance(mod, nn.Linear):
            put(mod.weight, np.asarray(p["kernel"]).T)
            put(mod.bias, p["bias"])
        else:
            transpose = isinstance(mod, nn.ConvTranspose2d)
            put(mod.weight, _conv_to_torch(np.asarray(p["kernel"]),
                                           transpose))
            put(mod.bias, p["bias"])


def export_flax_variables(ldm) -> Dict[str, Any]:
    """The inverse of ``load_flax_variables``: a flax-layout numpy tree."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def np32(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    for comp, name, mod in _layers(ldm):
        if isinstance(mod, nn.BatchNorm2d):
            _set(params.setdefault(comp, {}), name,
                 {src: np32(getattr(mod, dst)) for src, dst in _BN})
            _set(stats.setdefault(comp, {}), name,
                 {src: np32(getattr(mod, dst)) for src, dst in _STATS})
        elif isinstance(mod, nn.Linear):
            _set(params.setdefault(comp, {}), name,
                 {"kernel": np32(mod.weight).T.copy(),
                  "bias": np32(mod.bias)})
        else:
            transpose = isinstance(mod, nn.ConvTranspose2d)
            _set(params.setdefault(comp, {}), name,
                 {"kernel": _conv_to_flax(np32(mod.weight), transpose),
                  "bias": np32(mod.bias)})
    return {"params": params, "batch_stats": stats}


def _convs(module: nn.Module) -> Iterator[Tuple[str, nn.Conv2d]]:
    for name, child in module.named_modules():
        if isinstance(child, nn.Conv2d):
            yield name.replace(".", "/"), child


@torch.no_grad()
def load_flax_convs(module: nn.Module, params: Dict[str, Any]) -> None:
    """Fill every Conv2d of ``module`` in place from a flax params tree
    (kernel [kh, kw, I, O], bias when the conv has one)."""
    for path, conv in _convs(module):
        p = _get(params, path)
        conv.weight.copy_(torch.tensor(_conv_to_torch(
            np.asarray(p["kernel"], np.float32), False)))
        if conv.bias is not None:
            conv.bias.copy_(torch.tensor(np.asarray(p["bias"], np.float32)))


def export_flax_convs(module: nn.Module) -> Dict[str, Any]:
    """The inverse of ``load_flax_convs``: a flax-layout numpy tree."""
    params: Dict[str, Any] = {}
    for path, conv in _convs(module):
        leaf = {"kernel": _conv_to_flax(
            conv.weight.detach().float().cpu().numpy(), False)}
        if conv.bias is not None:
            leaf["bias"] = conv.bias.detach().float().cpu().numpy()
        _set(params, path, leaf)
    return params
