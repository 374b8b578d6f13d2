"""The device mesh of data parallelism.

A ``Mesh`` names the devices along the ``data`` axis (and a ``model``
axis of 1).  Under a process group (``parallel/distributed.py``) the data
axis is the ranks, one card each, and this process holds one index of it;
that is how the trainers run.  Otherwise it is the devices listed in one
process, which is how the serving engine runs its replicas; without
either it is the one local card.

A tensor carries no sharding in PyTorch, so the JAX package's
``batch_sharding`` / ``replicated_sharding`` / ``sequence_sharding`` have
no counterpart: ``parallel/sharding.py`` hands each rank (or each listed
device) its rows instead.  Tensor parallelism (a model axis > 1) and
sequence parallelism are the next slice; asking for either raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from music_style_transfer_ldm_tpu_torch.parallel.distributed import (
    process_device,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
NEXT_SLICE = ("tensor and sequence parallelism are not ported yet; the "
              "port runs data parallelism only (a mesh of (n, 1))")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {axis: size}; ``devices`` the device that owns each data
    index; ``group`` the process group when the data axis is ranks (None
    in one process); ``index`` this process's data index."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None
    index: int = 0

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def device(self) -> torch.device:
        """This process's device (the first one in one process)."""
        return self.devices[self.index]


def _resolve_shape(shape: Sequence[int], n: int) -> list:
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh {shape} != {n} devices")
    return shape


def _rank_devices(group, device=None) -> Tuple[torch.device, ...]:
    """Every rank's device, by one all_reduce of a [world] vector: rank r
    writes its card's index (-1 for the CPU) in slot r."""
    dev = process_device(device)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    slots = torch.zeros(world, dtype=torch.int64, device=dev)
    slots[rank] = dev.index if dev.type == "cuda" else -1
    dist.all_reduce(slots, group=group)
    return tuple(torch.device("cpu") if i < 0 else torch.device("cuda", i)
                 for i in slots.tolist())


def make_mesh(shape: Sequence[int] = (-1, 1),
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              devices=None, device=None) -> Mesh:
    """A mesh of ``shape`` (one entry may be -1, filled from the device
    count) over the process group's ranks, or over ``devices`` (a list
    may repeat a device: two replicas on one card), or over the one local
    card.  ``device`` is this rank's device when the process group was
    started outside ``initialize`` (``distributed.process_device``).
    ``axis_names`` keeps the JAX signature; only its length is read.
    ValueError for a shape that does not match the devices;
    NotImplementedError for a model axis > 1."""
    axis_names = tuple(axis_names)
    group, index = None, 0
    if devices is None and dist.is_initialized():
        group = dist.group.WORLD
        devs = _rank_devices(group, device)
        index = dist.get_rank()
    elif devices is not None:
        devs = tuple(torch.device(d) for d in devices)
    else:
        devs = (resolve_device("cuda"),)
    sizes = _resolve_shape(shape, len(devs))
    if len(sizes) != len(axis_names):
        raise ValueError(f"mesh {sizes} has {len(sizes)} axes but "
                         f"{len(axis_names)} names {axis_names}")
    if int(np.prod(sizes[1:])) > 1:
        raise NotImplementedError(NEXT_SLICE)
    return Mesh({DATA_AXIS: sizes[0], MODEL_AXIS: 1}, devs, group, index)
