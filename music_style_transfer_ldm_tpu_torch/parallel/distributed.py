"""Process-group start: one process per card.

``initialize()`` starts ``torch.distributed`` once per process, before
any model is built.  Under ``torch.distributed.run`` (torchrun) it reads
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` /
``MASTER_PORT`` from the environment; elsewhere the caller gives the
coordinator's address, the process count and this process's index.  With
neither it does nothing, as the JAX package's single-process no-op does.

Each rank owns one device: ``cuda:LOCAL_RANK`` unless the caller names
one (``device="cpu"`` for CPU ranks, or an explicit card, which is how
two ranks share one card on purpose).  A rank whose ``LOCAL_RANK`` has
no card raises: a rank never shares a card silently and never drops to
the CPU.  The backend is ``nccl`` for a card and ``gloo`` for the CPU
unless ``backend=`` says otherwise (``gloo`` also carries CUDA tensors
for ``all_reduce``, ``broadcast`` and ``barrier``, the only collectives
the training path uses).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device

_STATE: dict = {"device": None, "owned": False}


def _init_method(address: str) -> str:
    """A ``host:port`` address becomes ``tcp://host:port``; URLs
    (``tcp://``, ``file://``, ``env://``) pass."""
    return address if "://" in address else f"tcp://{address}"


def _rank_device(local_rank: int, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_rank >= count:
        raise RuntimeError(
            f"LOCAL_RANK {local_rank} has no card ({count} visible); a rank "
            "owns one card.  Pass device='cpu' to run ranks on the CPU, or "
            "name a card to share it on purpose")
    return torch.device("cuda", local_rank)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None) -> bool:
    """Start the process group; True when this call started it.

    A second call, or a call in a single process with no coordinator and
    no torchrun environment, does nothing and returns False."""
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return False
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("coordinator_address, num_processes and "
                             "process_id are given together")
        rank, world = int(process_id), int(num_processes)
        local_rank = int(env.get("LOCAL_RANK", rank))
        init_method = _init_method(coordinator_address)
    dev = _rank_device(local_rank, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank)
    _STATE.update(device=dev, owned=True)
    return True


def shutdown() -> None:
    """Destroy the process group this module started (a no-op
    otherwise)."""
    if _STATE["owned"] and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, owned=False)


def process_device(device=None) -> Optional[torch.device]:
    """This rank's device, or None outside a process group: the one
    ``initialize`` chose.  For a group started elsewhere, ``device`` (the
    caller's ask; a card without an index is the current card), or under
    nccl the current card; with neither it raises, since a rank never
    guesses the CPU."""
    if not dist.is_initialized():
        return None
    if _STATE["device"] is not None:
        return _STATE["device"]
    if device is None and dist.get_backend() == "nccl":
        device = "cuda"
    if device is None:
        raise RuntimeError(
            f"a {dist.get_backend()} process group started outside "
            "parallel.initialize() names no device for this rank: start "
            "it with parallel.initialize(), or name the device")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def process_info() -> dict:
    """The JAX package's keys: this process's index and the process
    count, and the devices this process and all processes drive (one
    per rank under a process group)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        return {"process_index": dist.get_rank(), "process_count": world,
                "local_devices": 1, "global_devices": world}
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return {"process_index": 0, "process_count": 1,
            "local_devices": local, "global_devices": local}
