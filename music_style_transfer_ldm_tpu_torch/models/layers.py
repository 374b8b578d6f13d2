"""Shared building blocks in NCHW: the convolution geometries, the
sinusoidal time embedding, style cross-attention and BatchNorm with
flax's semantics (with its pad-row mask, synchronised over ranks).

Geometry map from the JAX package's flax layers:
* ``conv_s1`` / ``conv_s2``: k3 convs, stride 1 / 2, padding 1;
* ``convT_k3`` (VALID + crop of the first row and column) is exactly
  ``ConvTranspose2d(k3, s2, p1, output_padding=1)``;
* ``convT_k4`` (flax SAME) is ``ConvTranspose2d(k4, s2, p1)``.

Under a model axis (``parallel/collectives.py ModelAxis``; ``ax`` below,
None outside one) ``conv``, ``linear`` and ``BatchNorm`` run a layer as
follows.  A layer is split when ``parallel/sharding.py shard_params``
kept only this rank's block of its output channels (``model_split``).

* Tensor parallelism: a split layer is column-parallel: its input goes
  through ``copy_to_model`` (the gradient is summed over the peers),
  it computes its block of output channels (a split BatchNorm
  normalises that block of its input, over the data group), and the
  blocks are gathered (backward: this rank's slice, since what follows
  runs alike on every peer).  A replicated layer runs as it is.
* Sequence parallelism: activations are split on their width.  A split
  layer's parameters are gathered before use (backward: summed over the
  peers, which each see one width block); a replicated one goes through
  ``copy_to_model``.  A conv on a width block takes its halo from the
  neighbours, by arithmetic from its geometry (``width_halo``): conv_s1
  one column each side, conv_s2 one on the left, convT_k4 one each side,
  convT_k3 one on the right; zeros past the clip's two edges.  A stride-2
  conv whose block is of odd width gathers the whole width first
  (``conv_down``), and that level runs replicated until ``conv_up``
  splits it again at the matching level on the way up.  BatchNorm takes
  its statistics over every rank (``group`` the world).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.parallel.collectives import (
    all_reduce_sum, copy_to_model, gather, halo,
)
from music_style_transfer_ldm_tpu_torch.parallel.sharding import (
    is_split, out_dim,
)


def conv_s1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=1, padding=1)


def conv_s2(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=2, padding=1)


def convT_k3(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                              output_padding=1)


def convT_k4(cin: int, cout: int) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)


def layer_params(module: nn.Module, ax=None):
    """(weight, bias) as a forward under ``ax`` uses them: the module's
    own, except under sequence parallelism, where a split module's blocks
    are gathered (summed backward) and a replicated one's parameters go
    through ``copy_to_model``."""
    w, b = module.weight, module.bias
    if ax is None or not ax.sequence:
        return w, b
    if is_split(module):
        return (gather(w, out_dim(module), ax, summed=True),
                None if b is None else gather(b, 0, ax, summed=True))
    return (copy_to_model(w, ax),
            None if b is None else copy_to_model(b, ax))


def width_halo(layer: nn.Module):
    """(left, right, crop) of a conv on a width block: the neighbours'
    columns it reads and, for a transpose conv run without width padding
    on the block with its halo, where its block's output starts.

    Conv (k, s, p): output j reads inputs s j - p .. s j - p + k - 1, so a
    block of W (a multiple of s) reads p columns before it and k - s - p
    after it.  Transpose conv: output o = s i - p + kk (kk < k), so a
    block reads floor((k - 1 - p) / s) inputs before it and
    floor((p - 1 + s) / s) after it, and its s W outputs start s left + p
    into the unpadded output."""
    k, s, p = layer.kernel_size[1], layer.stride[1], layer.padding[1]
    if isinstance(layer, nn.ConvTranspose2d):
        left = (k - 1 - p) // s
        return left, (p - 1 + s) // s, s * left + p
    return p, k - s - p, 0


def _conv(layer: nn.Module, x: torch.Tensor, w, b, width_pad: bool = True):
    """The layer's conv with the given parameters; ``width_pad`` False
    leaves the width unpadded (a width block with its halo)."""
    pad = layer.padding if width_pad else (layer.padding[0], 0)
    if isinstance(layer, nn.ConvTranspose2d):
        opad = (layer.output_padding if width_pad
                else (layer.output_padding[0], 0))
        return F.conv_transpose2d(x, w, b, layer.stride, pad, opad)
    return F.conv2d(x, w, b, layer.stride, pad)


def conv(layer: nn.Module, x: torch.Tensor, ax=None,
         sharded: bool = True) -> torch.Tensor:
    """``layer`` (Conv2d or ConvTranspose2d) on NCHW ``x`` under the
    model axis ``ax``; under sequence parallelism ``sharded`` says whether
    ``x`` is this rank's width block (else the whole width, alike on
    every peer)."""
    if ax is None:
        return layer(x)
    w, b = layer_params(layer, ax)
    if not ax.sequence:
        if not is_split(layer):
            return layer(x)
        return gather(_conv(layer, copy_to_model(x, ax), w, b), 1, ax)
    if not sharded:
        return _conv(layer, x, w, b)
    transpose = isinstance(layer, nn.ConvTranspose2d)
    if not transpose and x.shape[-1] % layer.stride[1]:
        raise ValueError(
            f"a width block of {x.shape[-1]} columns under a stride of "
            f"{layer.stride[1]}: sequence parallelism needs each rank's "
            "width to divide by the strides below it (the autoencoder's "
            "three stride-2 levels: a multiple of 8 per rank)")
    left, right, crop = width_halo(layer)
    y = _conv(layer, halo(x, left, right, ax), w, b, width_pad=False)
    if transpose:
        y = y[..., crop:crop + layer.stride[1] * x.shape[-1]]
    return y


def conv_down(layer: nn.Module, x: torch.Tensor, ax=None,
              sharded: bool = True):
    """A stride-2 ``conv``; -> (output, sharded).  Under sequence
    parallelism a width block of odd width is gathered to the whole
    width first (summed backward) and the output is whole."""
    if (ax is not None and ax.sequence and sharded
            and x.shape[-1] % layer.stride[1]):
        x, sharded = gather(x, -1, ax, summed=True), False
    return conv(layer, x, ax, sharded), sharded


def conv_up(layer: nn.Module, x: torch.Tensor, ax=None,
            sharded: bool = True, skip_sharded: bool = True
            ) -> torch.Tensor:
    """A transpose ``conv`` back to the level of a skip; under sequence
    parallelism a whole-width output is split again to this rank's block
    where the skip is one."""
    y = conv(layer, x, ax, sharded)
    if ax is not None and ax.sequence and skip_sharded and not sharded:
        y = y.chunk(ax.size, -1)[ax.index]
    return y


def linear(layer: nn.Linear, x: torch.Tensor, ax=None) -> torch.Tensor:
    """``layer`` on ``x`` [..., in] under the model axis ``ax`` (a split
    layer column-parallel under tensor parallelism)."""
    if ax is None:
        return layer(x)
    w, b = layer_params(layer, ax)
    if not ax.sequence and is_split(layer):
        return gather(F.linear(copy_to_model(x, ax), w, b), -1, ax)
    return F.linear(x, w, b)


def sinusoidal_embedding(time: torch.Tensor, dim: int = 128) -> torch.Tensor:
    """Transformer-style timestep embedding [B] -> [B, dim] (f32):
    scale = log(1e4)/(half-1), then [sin, cos]."""
    half = dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=time.device) * -scale)
    args = time.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalPositionEmbeddings(nn.Module):
    """``sinusoidal_embedding`` as a module: timesteps [B] -> [B, dim]."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.dim = dim

    def forward(self, time: torch.Tensor) -> torch.Tensor:
        return sinusoidal_embedding(time, self.dim)


def crop_k3_output(y: torch.Tensor) -> torch.Tensor:
    """The JAX package's crop of an NHWC VALID k3-transpose output to the
    p=1 / output_padding=1 geometry (``convT_k3`` computes it directly)."""
    return y[:, 1:, 1:, :]


class CrossAttention(nn.Module):
    """UNet features (queries) attend to style features (keys/values).

    Separate q/k/v/out projections with bias; logits divided by
    sqrt(head_dim); products accumulate and the softmax runs in f32.
    Under tensor parallelism each projection is ``linear``'s.  Under
    sequence parallelism the queries are this rank's tokens and the style
    map arrives whole (``StyleEncoder`` gathers s5 and s6 once, summed
    backward): k and v are projected from every style token on every
    peer, which is the projection of each width block gathered along the
    sequence, with half the bytes of gathering k and v.
    """

    def __init__(self, embed_dim: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, z: torch.Tensor, style: torch.Tensor,
                ax=None) -> torch.Tensor:
        """z [B, C, H, W], style [B, C, h, w] -> [B, C, H, W]."""
        B, C, H, W = z.shape
        nh, hd = self.num_heads, C // self.num_heads
        q_in = z.flatten(2).transpose(1, 2)          # [B, HW, C]
        kv_in = style.flatten(2).transpose(1, 2)     # [B, hw, C]
        q = linear(self.q_proj, q_in, ax).reshape(B, -1, nh, hd)
        k = linear(self.k_proj, kv_in, ax).reshape(B, -1, nh, hd)
        v = linear(self.v_proj, kv_in, ax).reshape(B, -1, nh, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        weights = torch.softmax(logits / math.sqrt(hd), dim=-1)
        attended = torch.einsum("bhqk,bkhd->bqhd",
                                weights.to(q.dtype).float(), v.float())
        attended = attended.to(z.dtype).reshape(B, H * W, C)
        out = linear(self.out_proj, attended, ax)
        return out.transpose(1, 2).reshape(B, C, H, W)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax ``nn.BatchNorm(momentum=0.9)`` semantics.

    ``train`` is explicit, as flax's ``use_running_average=not train``:
    False normalises with the running statistics whatever the module's
    mode.  True normalises with the batch mean and the *biased* batch
    variance, E[x^2] - E[x]^2 clipped at 0 (torch's BatchNorm2d updates
    its running variance with the unbiased one), and updates the running
    statistics with both: ra = m * ra + (1 - m) * batch, m = 0.9.
    Statistics and normalisation in f32, the result in the input's
    dtype.

    In train mode ``mask`` ([B], > 0 for a real row) leaves the pad rows
    out of the statistics (they are normalised all the same), as flax's
    ``mask=``; ``group`` (a process group) takes the statistics over
    every rank's rows: the sums S1 = sum x m, S2 = sum x^2 m and the
    count sum m H W go through one differentiable all_reduce, and every
    rank updates its running statistics with the same values.  With
    neither, the statistics are the plain means below.  Not
    ``torch.nn.SyncBatchNorm``: its running variance is the unbiased one
    and it takes no mask.

    Under a model axis ``ax`` (module docstring): a split layer under
    tensor parallelism normalises this rank's block of channels (its
    ``group`` the data group); under sequence parallelism (``group`` the
    world) the statistics span every channel and each rank keeps its
    block of the running ones."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)
        self.flax_momentum = momentum

    def _masked_stats(self, x32: torch.Tensor, mask, group):
        """(mean, biased var) over (N, H, W) of the rows ``mask`` keeps,
        over every rank of ``group``."""
        if mask is None:
            s1, s2 = x32.sum((0, 2, 3)), (x32 * x32).sum((0, 2, 3))
            count = torch.full((1,), float(x32.shape[0]), device=x32.device)
        else:
            m = (mask > 0).float().reshape(-1, 1, 1, 1)
            xm = x32 * m
            s1, s2 = xm.sum((0, 2, 3)), (xm * x32).sum((0, 2, 3))
            count = m.sum().reshape(1)
        count = count * float(x32.shape[2] * x32.shape[3])
        sums = torch.cat([s1, s2, count])
        if group is not None:
            sums = all_reduce_sum(sums, group, differentiable=True)
        c = x32.shape[1]
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        return mean, var

    def forward(self, x: torch.Tensor, train: bool = False,
                mask: Optional[torch.Tensor] = None,
                group=None, ax=None) -> torch.Tensor:
        split = ax is not None and is_split(self)
        if split and not ax.sequence:
            block = copy_to_model(x, ax).chunk(ax.size, 1)[ax.index]
            return gather(self._norm(block, train, mask, group, self.weight,
                                     self.bias), 1, ax)
        weight, bias = layer_params(self, ax)
        return self._norm(x, train, mask, group, weight, bias,
                          ax if split else None)

    def _norm(self, x: torch.Tensor, train: bool, mask, group, weight,
              bias, ax=None) -> torch.Tensor:
        """The normalisation with ``weight`` and ``bias`` over x's
        channels; with ``ax`` the running statistics are this rank's
        block of them."""
        shape = (1, -1, 1, 1)
        if not train:
            stats = (self.running_mean, self.running_var)
            if ax is not None:
                stats = tuple(gather(t, 0, ax) for t in stats)
            return F.batch_norm(x, *stats, weight, bias, False, 0.0,
                                self.eps)
        x32 = x.float()
        if mask is None and group is None:
            mean = x32.mean((0, 2, 3))
            var = torch.clamp((x32 * x32).mean((0, 2, 3)) - mean * mean,
                              min=0.0)
        else:
            mean, var = self._masked_stats(x32, mask, group)
        m = self.flax_momentum
        with torch.no_grad():
            batch = (mean.detach(), var.detach())
            if ax is not None:
                batch = tuple(t.chunk(ax.size)[ax.index] for t in batch)
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * batch[0])
            self.running_var.copy_(m * self.running_var
                                   + (1.0 - m) * batch[1])
        mul = torch.rsqrt(var + self.eps) * weight.float()
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape)
        return (y + bias.float().reshape(shape)).to(x.dtype)
