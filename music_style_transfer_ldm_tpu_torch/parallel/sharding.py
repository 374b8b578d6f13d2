"""Batches and parameters over the mesh's two axes.

Batches:

* ``batch_validity_weights``: 1 for each real row of a batch padded to a
  multiple, 0 for each pad row (None when nothing is padded); under a
  process group, this rank's data index's contiguous block of those
  rows, the layout of ``datasets/loader.py process_local_indices``;
* ``pad_batch_to_multiple``: repeat the last row up to a multiple;
* ``shard_batch``: pad, then this rank's rows on its card (the rows of
  its data index: model peers hold the same rows), or in one process
  every device's rows; with ``sequence_parallel`` also this rank's block
  of the NHWC width, zero-padded on the right up to a multiple of the
  model axis (the JAX package's rule);
* ``global_batch_from_local``: a loader's process-local rows (already
  sliced by the loader) on this rank's card;
* for the trainers: ``training_mesh`` (their mesh) and ``step_rows``
  (a step's rows on this process's device, with their weights under a
  process group; ``rank_batch`` and ``loader_global_rows`` below it).

Parameters (the JAX package's ``param_partition_spec``): at a model axis
m > 1 a layer is split over the model axis when its output channels
(flax's trailing axis) number at least 128 and divide by m; its bias and
its BatchNorm's scale, bias and running statistics split with it.  The
output channels lie on dim 0 of an ``nn.Conv2d`` weight [cout, cin, kh,
kw], of an ``nn.Linear`` weight [out, in] and of BatchNorm's vectors, and
on dim 1 of an ``nn.ConvTranspose2d`` weight [cin, cout, kh, kw].  In the
LDM that is 9,600,128 of its 9,881,537 parameters at m = 2 and m = 4.
``shard_params`` keeps this rank's block (``model_split`` marks the
layer), ``gather_params`` rebuilds the whole tensors, and
``gathered_state_dict`` gives them without touching the module.

How a step on an (n, m) mesh computes the one-process step:

* Tensor parallelism (``models/layers.py``): activations are whole and
  alike on the m peers.  A split layer is column-parallel: its input
  through ``copy_to_model`` (the input's gradient is summed over the
  peers), its block of output channels, then the blocks gathered
  (backward: this rank's slice, as the rest runs alike on every peer).
  A replicated parameter's gradient is then already whole and equal on
  every peer but for rounding, a split one's is its block's.  The losses
  run alike on every peer.  Before the optimizer steps,
  ``sync_replicated`` gives every peer model index 0's replicated
  gradients and BatchNorm statistics (one broadcast of about 1.1 MB in
  the LDM), so the peers' copies hold the same bits and cannot drift
  apart where cuDNN's sums are not deterministic.
* Sequence parallelism: every activation is this rank's width block.
  Every parameter's gradient is then partial, one part per width block:
  a split parameter is gathered before use and its gradient comes back
  by a reduce-scatter (summed over the blocks), a replicated one goes
  through ``copy_to_model`` (its gradient all-reduced over the model
  group).  Convs take halos; BatchNorm sums its statistics over the
  world.  The model's outputs are gathered to the whole width once and
  the losses (kernels D and E included) run on whole images alike on
  every peer; that gather's backward takes this rank's slice, so no
  term is counted m times.
* DistributedDataParallel then averages every gradient over the data
  group only (``collectives.DataParallel``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    count_collective, gather, model_axis,
)
from music_style_transfer_ldm_tpu_torch.parallel.mesh import (
    MODEL_AXIS, WIDTH_DIM, make_mesh,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device

MIN_SHARD_WIDTH = 128   # narrower layers stay whole: collectives dominate


def _tree_map(fn: Callable, tree):
    """``fn`` on every tensor or array of nested tuples, lists and dicts;
    other leaves (labels) pass."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _place(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device == device:
        return x
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def batch_validity_weights(n: int, multiple: int, mesh=None):
    """[padded n] float32 weights of a batch of ``n`` rows padded to a
    multiple of ``multiple``: n ones, then zeros; None when n divides.
    With a mesh the weights lie on its device, and under a process group
    they are this rank's data index's block of rows."""
    rem = n % multiple
    if rem == 0:
        return None
    w = np.zeros(n + multiple - rem, np.float32)
    w[:n] = 1.0
    if mesh is None:
        return torch.from_numpy(w)
    if mesh.distributed:
        n, d = mesh.data_size, mesh.data_index
        if len(w) % n:
            raise ValueError(f"{len(w)} padded rows do not split over "
                             f"{n} data indices")
        per = len(w) // n
        w = w[d * per:(d + 1) * per]
    return _place(torch.from_numpy(w), mesh.device)


def pad_batch_to_multiple(x, multiple: int):
    """Pad the leading axis up to a multiple by repeating the last row."""
    rem = x.shape[0] % multiple
    if rem == 0:
        return x
    filler = [x[-1:]] * (multiple - rem)
    if isinstance(x, np.ndarray):
        return np.concatenate([x] + filler)
    return torch.cat([x] + filler)


def _rows(x, n: int, pad: bool):
    if pad:
        x = pad_batch_to_multiple(x, n)
    if x.shape[0] % n:
        raise ValueError(f"batch of {x.shape[0]} rows does not split "
                         f"over {n} devices")
    per = x.shape[0] // n
    return [x[i * per:(i + 1) * per] for i in range(n)]


def width_block(x, mesh, pad: bool = True):
    """This rank's block of the NHWC width (``WIDTH_DIM``) of an array of
    3 or more dims, the width zero-padded on the right up to a multiple
    of the model axis first (``pad``); other arrays pass."""
    m = mesh.model_size
    if x.ndim <= WIDTH_DIM or m == 1:
        return x
    rem = x.shape[WIDTH_DIM] % m
    if rem:
        if not pad:
            raise ValueError(f"width {x.shape[WIDTH_DIM]} does not split "
                             f"over a model axis of {m}")
        widths = [(0, 0)] * x.ndim
        widths[WIDTH_DIM] = (0, m - rem)
        x = (np.pad(x, widths) if isinstance(x, np.ndarray) else
             torch.nn.functional.pad(x, [0, 0] * (x.ndim - WIDTH_DIM - 1)
                                     + [0, m - rem]))
    per = x.shape[WIDTH_DIM] // m
    i = mesh.model_index
    return x[(slice(None),) * WIDTH_DIM + (slice(i * per, (i + 1) * per),)]


def shard_batch(batch, mesh, pad: bool = True,
                sequence_parallel: bool = False):
    """Split every array of ``batch`` (nested tuples, lists, dicts) on its
    leading axis over the data axis; ``pad`` repeats trailing rows up to
    a multiple first.  Under a process group: the batch of this rank's
    data index's rows, on its card, and with ``sequence_parallel`` this
    rank's block of their NHWC width (``width_block``).  In one process:
    a list of batches, one per mesh device, each on its device."""
    n = mesh.data_size
    if mesh.distributed:
        def place(x):
            x = _rows(x, n, pad)[mesh.data_index]
            if sequence_parallel:
                x = width_block(x, mesh, pad)
            return _place(x, mesh.device)
        return _tree_map(place, batch)
    return [_tree_map(lambda x, i=i: _place(_rows(x, n, pad)[i], dev),
                      batch) for i, dev in enumerate(mesh.devices)]


def global_batch_from_local(local_batch, mesh):
    """A loader's process-local rows (``process_local_indices``' slice)
    on this rank's card; in one process, ``shard_batch(local_batch, mesh,
    pad=False)``."""
    if mesh.distributed:
        return _tree_map(lambda x: _place(x, mesh.device), local_batch)
    return shard_batch(local_batch, mesh, pad=False)


def is_split(module: nn.Module) -> bool:
    """Whether ``module`` holds only this rank's block of its output
    channels (``shard_params``)."""
    return getattr(module, "model_split", False)


def out_dim(module: nn.Module) -> int:
    """The dim of a layer's weight that holds its output channels (flax's
    trailing axis): 1 for a transpose conv's [cin, cout, kh, kw], else 0."""
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def _out_channels(module: nn.Module):
    for attr in ("out_channels", "out_features", "num_features"):
        if hasattr(module, attr):
            return getattr(module, attr)
    return None


def splits(module: nn.Module, m: int) -> bool:
    """The partition rule for one layer at a model axis of ``m``."""
    cout = (_out_channels(module) if isinstance(
        module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, nn.BatchNorm2d))
        else None)
    return (m > 1 and cout is not None and cout >= MIN_SHARD_WIDTH
            and cout % m == 0)


def _own_tensors(module: nn.Module):
    """(name, tensor, split dim) of a layer's parameters and buffers
    (BatchNorm's scalar batch count aside)."""
    for name, t in (list(module.named_parameters(recurse=False))
                    + list(module.named_buffers(recurse=False))):
        if t.ndim:
            yield name, t, out_dim(module) if name == "weight" else 0


def param_partition(module: nn.Module, m: int) -> dict:
    """{qualified name: split dim} of every parameter and buffer of
    ``module`` that a model axis of ``m`` splits."""
    return {f"{prefix}.{name}" if prefix else name: dim
            for prefix, mod in module.named_modules() if splits(mod, m)
            for name, _, dim in _own_tensors(mod)}


def split_dims(module: nn.Module) -> dict:
    """{qualified name: dim} of the tensors ``shard_params`` split."""
    return {f"{prefix}.{name}" if prefix else name: dim
            for prefix, mod in module.named_modules() if is_split(mod)
            for name, _, dim in _own_tensors(mod)}


def param_partition_spec(name: str, tensor, mesh, module: nn.Module
                         ) -> tuple:
    """The placement of ``module``'s parameter or buffer ``name`` (a
    qualified name in ``module``; ``tensor`` is its value) under
    ``shard_params`` on ``mesh``: MODEL_AXIS on the split dim (torch's
    layout: dim 0 of a conv or linear weight, dim 1 of a transpose
    conv's), None on every other dim.  JAX keys its rule by the leaf's
    path and shape; a torch tensor does not know its layer, so the root
    module is the fourth argument."""
    prefix, _, leaf = name.rpartition(".")
    layer = module.get_submodule(prefix)
    dim = param_partition(layer, mesh.model_size).get(leaf)
    return tuple(MODEL_AXIS if d == dim else None
                 for d in range(tensor.ndim))


def param_sharding_tree(module: nn.Module, mesh) -> dict:
    """{qualified name: ``param_partition_spec``} of every parameter and
    buffer of ``module``."""
    return {name: param_partition_spec(name, t, mesh, module)
            for name, t in module.state_dict(keep_vars=True).items()}


@torch.no_grad()
def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Every rank takes rank 0's parameters and buffers (a no-op in one
    process); then at a model axis > 1 each split layer keeps this rank's
    block of its tensors and is marked ``model_split``.  In place;
    returns the module."""
    if mesh.distributed:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=mesh.group)
    m = mesh.model_size
    for mod in module.modules():
        if is_split(mod) or not splits(mod, m):
            continue
        for _, t, dim in _own_tensors(mod):
            t.data = t.data.chunk(m, dim)[mesh.model_index].clone()
        mod.model_split = True
    return module


@torch.no_grad()
def gather_params(module: nn.Module, mesh) -> nn.Module:
    """The inverse of ``shard_params``: every split layer's whole tensors
    again (every model peer calls it).  In place; returns the module."""
    ax = model_axis(mesh)
    for mod in module.modules():
        if is_split(mod):
            for _, t, dim in _own_tensors(mod):
                t.data = gather(t.data, dim, ax)
            mod.model_split = False
    return module


@torch.no_grad()
def sync_replicated(module: nn.Module, ax) -> None:
    """Under tensor parallelism (``ax`` a model axis without
    ``sequence``), every replicated parameter's gradient and floating
    buffer (BatchNorm's running statistics) of ``module`` set to model
    index 0's, in one broadcast per dtype, in place.  The peers compute
    these alike but for rounding (cuDNN's default algorithms are not
    deterministic), and a peer that stepped on other bits would drift
    from the rest step after step; after this they hold the same bits.
    Nothing to do outside a model axis and under sequence parallelism,
    whose replicated gradients come all-reduced (``copy_to_model``) and
    whose statistics are sums over the world, the same bits on every
    peer.  Between backward and the optimizer's step."""
    if ax is None or ax.sequence:
        return
    by_dtype: dict = {}
    for mod in module.modules():
        if is_split(mod):
            continue
        for p in mod.parameters(recurse=False):
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for b in mod.buffers(recurse=False):
            if b.is_floating_point():
                by_dtype.setdefault(b.dtype, []).append(b)
    src = dist.get_global_rank(ax.group, 0)
    for tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        count_collective(flat, "model")
        dist.broadcast(flat, src, group=ax.group)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))


@torch.no_grad()
def gather_tensors(tensors: dict, dims: dict, mesh) -> dict:
    """``tensors`` by name with those named in ``dims`` (a ``split_dims``)
    gathered whole over the model group (every model peer calls it)."""
    if not dims:
        return dict(tensors)
    ax = model_axis(mesh)
    return {k: gather(v, dims[k], ax) if k in dims else v
            for k, v in tensors.items()}


def gathered_state_dict(module: nn.Module, mesh) -> dict:
    """``module``'s state dict with every split tensor whole."""
    return gather_tensors(module.state_dict(), split_dims(module), mesh)


def local_blocks(tensors: dict, dims: dict, mesh) -> dict:
    """Whole ``tensors`` by name, those named in ``dims`` cut to this
    rank's block: how a whole checkpoint loads into a split module."""
    m, i = mesh.model_size, mesh.model_index
    return {k: v.chunk(m, dims[k])[i].clone() if k in dims else v
            for k, v in tensors.items()}


def loader_global_rows(loader, i: int, mesh):
    """The real rows of global batch ``i`` when ``loader`` yields this
    process's slices of it (``EpochBatches`` with ``process_count`` the
    world size); None when it yields whole global batches
    (``process_count`` 1, or a plain iterable).  A loader sliced for
    another world size raises."""
    count = getattr(loader, "process_count", 1)
    if count == 1:
        return None
    if count != mesh.data_size or not hasattr(loader, "global_rows"):
        raise ValueError(f"a loader sliced for {count} processes on a mesh "
                         f"of {mesh.data_size} data indices")
    return loader.global_rows(i)


def rank_batch(arrays, mesh, global_rows=None,
               sequence_parallel: bool = False):
    """(arrays, weights) of one step under a process group: this rank's
    data index's rows of ``arrays`` on its card (with
    ``sequence_parallel``, this rank's block of their width) and their
    validity weights (None when no row is padded).  With ``global_rows``
    None the arrays are the whole global batch (padded and split here);
    otherwise they are this data index's slice of a global batch of that
    many real rows."""
    n = mesh.data_size
    if global_rows is None:
        leaves = []
        _tree_map(leaves.append, arrays)
        return (shard_batch(arrays, mesh, sequence_parallel=sequence_parallel),
                batch_validity_weights(leaves[0].shape[0], n, mesh))

    def place(x):
        return _place(width_block(x, mesh) if sequence_parallel else x,
                      mesh.device)
    return (_tree_map(place, arrays),
            batch_validity_weights(global_rows, n, mesh))


def step_rows(arrays, mesh, loader=None, i: int = 0,
              sequence_parallel: bool = False):
    """(arrays, weights) of step ``i`` of ``loader``: in one process the
    arrays on the mesh's device and no weights; under a process group
    ``rank_batch`` (this rank's rows, or with ``sequence_parallel`` its
    width block of them, and their validity weights, None when no row is
    padded), reading from ``loader`` whether the arrays are this data
    index's slice or the whole global batch."""
    if not mesh.distributed:
        return _tree_map(lambda x: _place(x, mesh.device), arrays), None
    return rank_batch(arrays, mesh, loader_global_rows(loader, i, mesh),
                      sequence_parallel)


def training_mesh(mesh_config, mesh=None, device="cuda"):
    """A trainer's mesh: the given one, else ``mesh_config.mesh_shape``
    over the process group's ranks (``device`` names this rank's device
    when the group was started outside ``initialize``) or, in one
    process, over ``device``.  Training spans cards with one process per
    card, so a single-process mesh of more than one device is refused."""
    if mesh is None:
        if dist.is_initialized():
            mesh = make_mesh(mesh_config.mesh_shape, device=device)
        else:
            mesh = make_mesh(mesh_config.mesh_shape,
                             devices=[resolve_device(device)])
    if not mesh.distributed and mesh.size > 1:
        raise ValueError(
            f"a trainer's mesh of {mesh.size} devices in one process: "
            "training runs one process per card (python -m "
            "torch.distributed.run --nproc-per-node N ...)")
    return mesh
