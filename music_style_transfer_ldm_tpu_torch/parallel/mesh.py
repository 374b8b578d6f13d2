"""The device mesh: a data axis and a model axis.

A ``Mesh`` of shape (n, m) names n x m devices.  Under a process group
(``parallel/distributed.py``) they are the ranks, one card each, laid out
row-major as the JAX package's ``np.asarray(devices).reshape(shape)``:
rank r is data index ``r // m`` and model index ``r % m``.  The m
consecutive ranks of one data index form its ``model_group`` (they hold
the same rows and split the parameters, or the width, between them);
the n ranks of one model index form its ``data_group`` (they hold the
same parameter blocks and split the rows).  That is how the trainers
run.  Without a process group the mesh is the devices listed in one
process, which is how the serving engine runs its replicas, or the one
local card; a model axis > 1 needs a process group (one process per
rank), so it raises there.

A tensor carries no sharding in PyTorch: ``parallel/sharding.py`` hands
each rank its rows (and, under sequence parallelism, its width block)
and its parameter blocks.  ``batch_sharding``, ``replicated_sharding``
and ``sequence_sharding`` keep the JAX package's names for the
placements it makes: a tuple with an axis name or None per dimension of
an NHWC batch (JAX's ``PartitionSpec``, as a tuple).
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
# The dims of an NHWC batch that ``sharding.shard_batch`` splits: rows
# over the data axis, and under sequence parallelism the width (the
# spectrogram's time) over the model axis (``sharding.width_block``, for
# batches of 3 or more dims).
BATCH_DIM, WIDTH_DIM = 0, 2


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` {axis: size}; ``devices`` every rank's (or listed)
    device, row-major over (data, model); ``group`` the process group of
    every rank (None in one process); ``index`` this process's rank (its
    slot in ``devices``); ``data_group`` / ``model_group`` the ranks that
    share its model index / its data index (the world and None at a
    model axis of 1)."""

    shape: Dict[str, int]
    devices: Tuple[torch.device, ...]
    group: Optional[object] = None
    index: int = 0
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def __post_init__(self):
        if self.data_group is None and self.model_size == 1:
            object.__setattr__(self, "data_group", self.group)

    @property
    def size(self) -> int:
        """Every device of the mesh (the world under a process group)."""
        return len(self.devices)

    @property
    def data_size(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def data_index(self) -> int:
        return self.index // self.model_size

    @property
    def model_index(self) -> int:
        return self.index % self.model_size

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


def _axis_groups(n: int, m: int, rank: int):
    """(data group, model group) of ``rank`` on an (n, m) process mesh.
    Every rank creates every group, in the same order, as
    ``dist.new_group`` requires."""
    data = model = None
    for j in range(m):
        g = dist.new_group([d * m + j for d in range(n)])
        if rank % m == j:
            data = g
    for d in range(n):
        g = dist.new_group([d * m + j for j in range(m)])
        if rank // m == d:
            model = g
    return data, model


def make_mesh(shape: Sequence[int] = (-1, 1),
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              devices=None, device=None) -> Mesh:
    """A mesh of ``shape`` (one entry may be -1, filled from the device
    count) over the process group's ranks, or over ``devices`` (a list
    may repeat a device: two replicas on one card), or over the one local
    card.  ``device`` is this rank's device when the process group was
    started outside ``initialize`` (``distributed.process_device``).
    ``axis_names`` keeps the JAX signature; only its length is read.
    ValueError for a shape that does not match the devices, and for a
    model axis > 1 in one process."""
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
    if group is None and any(s > 1 for s in tuple(shape)[1:]):
        raise ValueError(
            f"a model axis in one process (mesh {tuple(shape)}): tensor and "
            "sequence parallelism run one process per rank (python -m "
            "torch.distributed.run --nproc-per-node N ... with "
            "config.mesh.mesh_shape = (n, m))")
    sizes = _resolve_shape(shape, len(devs))
    if len(sizes) != len(axis_names):
        raise ValueError(f"mesh {sizes} has {len(sizes)} axes but "
                         f"{len(axis_names)} names {axis_names}")
    n, m = sizes[0], int(np.prod(sizes[1:]))
    if m > 1 and group is None:      # a model axis of -1 resolved above 1
        raise ValueError(f"a model axis of {m} in one process: one process "
                         "per rank (python -m torch.distributed.run)")
    data_group = model_group = None
    if m > 1:
        data_group, model_group = _axis_groups(n, m, index)
    return Mesh({DATA_AXIS: n, MODEL_AXIS: m}, devs, group, index,
                data_group, model_group)


def batch_sharding(mesh: Mesh, ndim: int = 4) -> tuple:
    """``shard_batch``'s placement of an ``ndim``-dim batch: its rows over
    the data axis, the rest whole."""
    spec = [None] * ndim
    spec[BATCH_DIM] = DATA_AXIS
    return tuple(spec)


def replicated_sharding(mesh: Mesh) -> tuple:
    """A tensor whole on every device: no dim split."""
    return ()


def sequence_sharding(mesh: Mesh, ndim: int = 4) -> tuple:
    """``shard_batch(..., sequence_parallel=True)``'s placement: the rows
    over the data axis and, for 3 or more dims, the NHWC width over the
    model axis."""
    spec = list(batch_sharding(mesh, ndim))
    if ndim > WIDTH_DIM:
        spec[WIDTH_DIM] = MODEL_AXIS
    return tuple(spec)
