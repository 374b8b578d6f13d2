"""The collectives of the data-parallel training path.

Only ``all_reduce`` and ``broadcast`` (and ``barrier``) are used: they
are what ``gloo`` implements for CUDA tensors as well as ``nccl``, so
the same path runs two ranks on one card over ``gloo``.

* ``all_reduce_sum``: a sum over the ranks, differentiable on request
  (its backward all-reduces the incoming gradient, which is the
  gradient of the sum of every rank's loss);
* ``global_loss_weights``: the loss weights and the factor that turn a
  rank's weighted mean into world x (its weighted sum) / (global sum of
  weights), so DistributedDataParallel's gradient mean is the gradient
  of the global weighted mean;
* ``DataParallel``: the module wrapped in DistributedDataParallel under
  a process group (``broadcast_buffers=False``: BatchNorm synchronises
  its statistics itself).

``COUNTS`` adds up the bytes and calls of the all-reduces made here
(DistributedDataParallel's gradient buckets are not counted).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

COUNTS = {"all_reduce_calls": 0, "all_reduce_bytes": 0}


def _count(t: torch.Tensor) -> None:
    COUNTS["all_reduce_calls"] += 1
    COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        _count(y)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        _count(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group,
                   differentiable: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    if differentiable:
        return _AllReduceSum.apply(x, group)
    y = x.detach().clone()
    _count(y)
    dist.all_reduce(y, group=group)
    return y


def global_loss_weights(weights: Optional[torch.Tensor], mesh
                        ) -> Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
    """(loss weights, scale) for this rank's rows.

    The losses compute a weighted mean over the rank's rows; times
    ``scale`` = world x (local sum of weights) / (global sum) it is world
    x the rank's weighted sum over the global sum, whose mean over the
    ranks is the global weighted mean.  A rank with no real row gets
    weights of ones (a finite mean) and a scale of 0.  Without weights
    (no pad row anywhere, every rank the same row count) or outside a
    process group: (weights, None), no scaling."""
    if weights is None or not mesh.distributed:
        return weights, None
    w = weights.float()
    local = w.sum()
    total = all_reduce_sum(local, mesh.group)
    w = torch.where(local > 0, w, torch.ones_like(w))
    return w, local * mesh.size / total


def all_reduce_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks (``x`` itself in one process)."""
    if not mesh.distributed:
        return x
    return all_reduce_sum(x, mesh.group) / mesh.size


class DataParallel:
    """The module a training step runs: under a process group the module
    in DistributedDataParallel, built once per module (its construction
    broadcasts rank 0's parameters and buffers); the module itself
    otherwise."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._ddp = None

    def __call__(self, module: nn.Module) -> nn.Module:
        if not self.mesh.distributed:
            return module
        if self._ddp is None or self._ddp.module is not module:
            dev = self.mesh.device
            self._ddp = nn.parallel.DistributedDataParallel(
                module, device_ids=[dev.index] if dev.type == "cuda"
                else None, process_group=self.mesh.group,
                broadcast_buffers=False)
        return self._ddp


def is_main(mesh) -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return not mesh.distributed or mesh.index == 0


def barrier(mesh) -> None:
    if mesh.distributed:
        dist.barrier(group=mesh.group)
