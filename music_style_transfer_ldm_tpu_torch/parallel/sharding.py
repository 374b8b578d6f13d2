"""Batches and parameters over the data axis.

* ``batch_validity_weights``: 1 for each real row of a batch padded to a
  multiple, 0 for each pad row (None when nothing is padded); under a
  process group, this rank's contiguous block of those rows, the layout
  of ``datasets/loader.py process_local_indices``;
* ``pad_batch_to_multiple``: repeat the last row up to a multiple;
* ``shard_batch``: pad, then this rank's rows on its card, or in one
  process every device's rows;
* ``global_batch_from_local``: a loader's process-local rows (already
  sliced by the loader) on this rank's card;
* ``shard_params``: at a model axis of 1, replication: every rank takes
  rank 0's parameters and buffers;
* for the trainers: ``training_mesh`` (their mesh) and ``step_rows``
  (a step's rows on this process's device, with their weights under a
  process group; ``rank_batch`` and ``loader_global_rows`` below it).

The JAX package's tensor-parallel ``param_partition_spec`` belongs to
the next slice (``parallel/mesh.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from music_style_transfer_ldm_tpu_torch.parallel.mesh import (
    NEXT_SLICE, make_mesh,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device


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
    they are this rank's block of rows."""
    rem = n % multiple
    if rem == 0:
        return None
    w = np.zeros(n + multiple - rem, np.float32)
    w[:n] = 1.0
    if mesh is None:
        return torch.from_numpy(w)
    if mesh.distributed:
        if len(w) % mesh.size:
            raise ValueError(f"{len(w)} padded rows do not split over "
                             f"{mesh.size} ranks")
        per = len(w) // mesh.size
        w = w[mesh.index * per:(mesh.index + 1) * per]
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


def shard_batch(batch, mesh, pad: bool = True):
    """Split every array of ``batch`` (nested tuples, lists, dicts) on its
    leading axis over the data axis; ``pad`` repeats trailing rows up to
    a multiple first.  Under a process group: the batch of this rank's
    rows, on its card.  In one process: a list of batches, one per mesh
    device, each on its device.  (Sequence parallelism, the JAX
    package's ``sequence_parallel=True``, is the next slice.)"""
    n = mesh.size
    if mesh.distributed:
        return _tree_map(lambda x: _place(_rows(x, n, pad)[mesh.index],
                                          mesh.device), batch)
    return [_tree_map(lambda x, i=i: _place(_rows(x, n, pad)[i], dev),
                      batch) for i, dev in enumerate(mesh.devices)]


def global_batch_from_local(local_batch, mesh):
    """A loader's process-local rows (``process_local_indices``' slice)
    on this rank's card; in one process, ``shard_batch(local_batch, mesh,
    pad=False)``."""
    if mesh.distributed:
        return _tree_map(lambda x: _place(x, mesh.device), local_batch)
    return shard_batch(local_batch, mesh, pad=False)


@torch.no_grad()
def shard_params(module: nn.Module, mesh) -> nn.Module:
    """Replicate ``module`` over the ranks: every parameter and buffer
    becomes rank 0's (a no-op in one process).  Returns the module."""
    if mesh.distributed:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=mesh.group)
    return module


def loader_global_rows(loader, i: int, mesh):
    """The real rows of global batch ``i`` when ``loader`` yields this
    process's slices of it (``EpochBatches`` with ``process_count`` the
    world size); None when it yields whole global batches
    (``process_count`` 1, or a plain iterable).  A loader sliced for
    another world size raises."""
    count = getattr(loader, "process_count", 1)
    if count == 1:
        return None
    if count != mesh.size or not hasattr(loader, "global_rows"):
        raise ValueError(f"a loader sliced for {count} processes on a mesh "
                         f"of {mesh.size} ranks")
    return loader.global_rows(i)


def rank_batch(arrays, mesh, global_rows=None):
    """(arrays, weights) of one step under a process group: this rank's
    rows of ``arrays`` on its card and their validity weights (None when
    no row is padded).  With ``global_rows`` None the arrays are the
    whole global batch (padded and split here); otherwise they are this
    rank's slice of a global batch of that many real rows."""
    if global_rows is None:
        leaves = []
        _tree_map(leaves.append, arrays)
        n = leaves[0].shape[0]
        return (shard_batch(arrays, mesh),
                batch_validity_weights(n, mesh.size, mesh))
    return (_tree_map(lambda x: _place(x, mesh.device), arrays),
            batch_validity_weights(global_rows, mesh.size, mesh))


def step_rows(arrays, mesh, loader=None, i: int = 0):
    """(arrays, weights) of step ``i`` of ``loader``: in one process the
    arrays on the mesh's device and no weights; under a process group
    ``rank_batch`` (this rank's rows and their validity weights, None
    when no row is padded), reading from ``loader`` whether the arrays
    are this rank's slice or the whole global batch."""
    if not mesh.distributed:
        return _tree_map(lambda x: _place(x, mesh.device), arrays), None
    return rank_batch(arrays, mesh, loader_global_rows(loader, i, mesh))


def training_mesh(mesh_config, mesh=None, device="cuda"):
    """A trainer's mesh: the given one, else ``mesh_config.mesh_shape``
    over the process group's ranks (``device`` names this rank's device
    when the group was started outside ``initialize``) or, in one
    process, over ``device``.  Training spans cards with one process per
    card, so a single-process mesh of more than one device is refused."""
    if mesh_config.sequence_parallel:
        raise NotImplementedError(NEXT_SLICE)
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
