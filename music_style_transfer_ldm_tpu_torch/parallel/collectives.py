"""The collectives of the training path, over the mesh's two axes.

Data axis (``mesh.data_group``: the ranks of one model index):

* ``all_reduce_sum``: a sum over a group, differentiable on request (its
  backward all-reduces the incoming gradient, which is the gradient of
  the sum of every rank's loss);
* ``global_loss_weights``: the loss weights and the factor that turn a
  rank's weighted mean into n x (its weighted sum) / (global sum of
  weights), so DistributedDataParallel's gradient mean over the n data
  indices is the gradient of the global weighted mean;
* ``DataParallel``: the module wrapped in DistributedDataParallel over
  the data group (``broadcast_buffers=False``: BatchNorm synchronises
  its statistics itself).  Over the whole world it would broadcast rank
  0's parameter blocks into its model peers' different blocks, and
  average different blocks together.

Model axis (``ModelAxis``: the m ranks of one data index), the
``torch.autograd.Function``s that GSPMD inserts in the JAX package:

* ``copy_to_model``: identity forward, all-reduce of the gradient
  backward (before a column-parallel layer; on a replicated parameter
  under sequence parallelism);
* ``gather``: all-gather along a dim.  Backward, this rank's slice of
  the gradient when what follows is computed identically, with the
  whole gradient, on every peer (tensor parallelism's channel gather);
  with ``summed``, the reduce-scatter (sum over the peers, this rank's
  slice) when each peer holds only its part of the gradient (sequence
  parallelism's gathers of width and of parameter blocks);
* ``halo``: the neighbours' edge columns around this rank's width block
  (zeros at the clip's two edges); backward, each halo's gradient is
  added into the neighbour's edge columns.

Which collectives the backends give: ranks that share one card run over
gloo (nccl refuses two ranks on one card).  On torch 2.11 with CUDA
tensors gloo takes all_reduce, all_gather, reduce_scatter (and their
single-tensor forms, and all_to_all), while send / recv of a CUDA tensor
aborts the process.  So the model axis is built from list-form
``all_gather`` and ``reduce_scatter`` and ``all_reduce`` only (the list
forms: the single-tensor ones are deprecated in later torch), and the
halo is an all-gather of every rank's edge columns rather than a
point-to-point exchange; nccl runs the same calls.

``COUNTS`` adds up the calls and the bytes of the full operand (the
tensor all-reduced, the tensor gathered, the tensor reduce-scattered) of
the collectives made here: ``all_reduce_*`` for the sums of statistics,
loss weights and metrics (over the data group, or over the world for
sequence parallelism's BatchNorm and the metrics), ``model_*`` for the
model axis (``sharding.sync_replicated``'s broadcast included).
DistributedDataParallel's gradient buckets (every trainable local
parameter's gradient, once a step) are not counted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

COUNTS = {"all_reduce_calls": 0, "all_reduce_bytes": 0,
          "model_calls": 0, "model_bytes": 0}


def count_collective(t: torch.Tensor, axis: str = "all_reduce") -> None:
    """One call of ``t``'s bytes in ``COUNTS`` under ``axis``."""
    COUNTS[axis + "_calls"] += 1
    COUNTS[axis + "_bytes"] += t.numel() * t.element_size()



class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        count_collective(y)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        count_collective(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group,
                   differentiable: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    if differentiable:
        return _AllReduceSum.apply(x, group)
    y = x.detach().clone()
    count_collective(y)
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
    total = all_reduce_sum(local, mesh.data_group)
    w = torch.where(local > 0, w, torch.ones_like(w))
    return w, local * mesh.data_size / total


def all_reduce_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over every rank (``x`` itself in one process).
    Model peers hold their data index's value alike but for the rounding
    of their forwards, so this is the mean over the data indices, and
    every rank gets the same bits, so the host's decisions on it (the
    plateau scheduler's) agree.  It is a metric, never a check that the
    peers agree: ``sharding.sync_replicated`` keeps their replicated
    parameters equal."""
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
                else None, process_group=self.mesh.data_group,
                broadcast_buffers=False)
        return self._ddp


def is_main(mesh) -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return not mesh.distributed or mesh.index == 0


def barrier(mesh) -> None:
    if mesh.distributed:
        dist.barrier(group=mesh.group)


# ---------------- the model axis ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """A forward split over one data index's model group (``size``
    ranks, this one ``index``): tensor parallel (a split layer computes
    its block of output channels) or, with ``sequence``, sequence
    parallel (activations split on their width, NCHW's last dim)."""

    group: object
    size: int
    index: int
    sequence: bool = False


def model_axis(mesh, sequence: bool = False) -> Optional[ModelAxis]:
    """The mesh's model axis as a forward sees it; None at size 1."""
    if mesh.model_size == 1:
        return None
    return ModelAxis(mesh.model_group, mesh.model_size, mesh.model_index,
                     sequence)


def _all_gather(x: torch.Tensor, dim: int, ax: ModelAxis) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    out = torch.cat(parts, dim)
    count_collective(out, "model")
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        count_collective(g, "model")
        dist.all_reduce(g, group=ctx.ax.group)
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax, summed):
        ctx.dim, ctx.ax, ctx.summed = dim, ax, summed
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, grad):
        ax, dim = ctx.ax, ctx.dim
        if not ctx.summed:
            return grad.chunk(ax.size, dim)[ax.index].contiguous(), \
                None, None, None
        chunks = [c.contiguous() for c in grad.chunk(ax.size, dim)]
        out = torch.empty_like(chunks[ax.index])
        count_collective(grad, "model")
        dist.reduce_scatter(out, chunks, group=ax.group)
        return out, None, None, None


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left, right, ax):
        ctx.left, ctx.right, ctx.ax = left, right, ax
        w = x.shape[-1]
        # what the neighbours need: the first `right` columns (the left
        # neighbour's right halo), the last `left` (the right one's left)
        parts = _all_gather(torch.cat([x[..., :right], x[..., w - left:]],
                                      -1), -1, ax).chunk(ax.size, -1)
        i = ax.index
        lo = (parts[i - 1][..., right:] if i > 0
              else x.new_zeros(x.shape[:-1] + (left,)))
        hi = (parts[i + 1][..., :right] if i + 1 < ax.size
              else x.new_zeros(x.shape[:-1] + (right,)))
        return torch.cat([lo, x, hi], -1)

    @staticmethod
    def backward(ctx, grad):
        left, right, ax = ctx.left, ctx.right, ctx.ax
        w = grad.shape[-1] - left - right
        parts = _all_gather(torch.cat([grad[..., :left],
                                       grad[..., left + w:]], -1),
                            -1, ax).chunk(ax.size, -1)
        g = grad[..., left:left + w].clone()
        i = ax.index
        if i + 1 < ax.size and left:   # my last columns were its left halo
            g[..., w - left:] += parts[i + 1][..., :left]
        if i > 0 and right:            # my first columns, its right halo
            g[..., :right] += parts[i - 1][..., left:]
        return g, None, None, None


def copy_to_model(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """``x`` as is; its gradient summed over the model group."""
    return _Copy.apply(x, ax)


def gather(x: torch.Tensor, dim: int, ax: ModelAxis,
           summed: bool = False) -> torch.Tensor:
    """Every model peer's ``x`` concatenated along ``dim``, in model
    index order.  The gradient comes back as this rank's slice, or with
    ``summed`` as the sum over the peers of their slices for this rank."""
    return _Gather.apply(x, dim, ax, summed)


def halo(x: torch.Tensor, left: int, right: int,
         ax: ModelAxis) -> torch.Tensor:
    """This rank's width block [..., W] with ``left`` columns of its left
    neighbour before it and ``right`` of its right neighbour after it;
    zeros past the first and the last rank."""
    if not left and not right:
        return x
    return _Halo.apply(x, left, right, ax)
