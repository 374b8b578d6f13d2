"""The VGGish style-loss trunk, forward and pred-side input gradient, as
CUDA kernels (kernel E).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/fused_trunk.py``
(``fused_vggish_distance``, ``fused_vggish_distance_value``,
``fused_supported``).  Its split is kept: conv1 and conv1's input
gradient run here in PyTorch (``F.conv2d`` on dtype-rounded operands in
exact f32, f32 bias and ReLU, then the dtype), and ``fused_trunk`` runs
the rest from f1, conv1's output for both branches stacked on the batch
dimension ([2B, H, W, C1] NHWC, pred rows then target rows):

* conv2 ... conv4_2 with the three 2x2 max-pools
  (``csrc/fused_trunk.cu``; in bf16 tensor-core implicit GEMMs fed by
  TMA, in f32 the CUDA-core parity instrument), and the six per-layer
  metrics through kernel D's forward (``ops/normalized_mse.py``) on each
  map's pred and target halves: m [B, 6];
* with grad, for each layer from 6 down to 1: kernel D's direct metric
  gradient (unit upstream x 1/6) added to the incoming gradient under the
  ReLU mask of the stored pred map, written in the dtype, the conv
  input-gradient kernel and the first-match unpool kernel; the result g1
  [B, H, W, C1] is the gradient of mean_l m_l at conv1's (masked) output.

The weights are packed per call by ``forward_weights`` and
``dgrad_weights`` (plain PyTorch).  The bf16 kernels take channels in
multiples of 64 and whole tiles of 8 rows x 16 columns at every conv
(``tc_fits``); ``fused_supported`` says so, ``losses/vggish.py`` routes
any other bf16 geometry to the per-layer route, and ``fused_trunk``
raises on it.

On a CUDA tensor ``fused_trunk`` launches the kernels; on a CPU tensor it
runs ``fused_trunk_reference`` (the trunk in plain PyTorch, autograd for
g1); on any other device it raises.  ``fused_vggish_distance`` is an
autograd Function: gradients to pred and weights, and a zero gradient to
target by design (the style target is data; callers that need the target
gradient use the per-layer route, ``losses/vggish.py``).
``fused_vggish_distance_reference`` is the plain version of the whole
distance: the trunk in plain PyTorch and the plain normalized MSE.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.ops._build import build_library
from music_style_transfer_ldm_tpu_torch.ops.normalized_mse import (
    normalized_mse_backward, normalized_mse_forward,
    normalized_mse_forward_reference,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import exact_float32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv_relu(x: torch.Tensor, conv: nn.Conv2d,
              dtype: torch.dtype) -> torch.Tensor:
    """relu(round_dtype(conv(x) + bias)), NCHW, on dtype-rounded operands
    in f32 (the trunk's rounding points); call under ``exact_float32``."""
    y = F.conv2d(x.to(dtype).float(), conv.weight.to(dtype).float(),
                 conv.bias.float(), stride=conv.stride, padding=conv.padding)
    return torch.relu(y.to(dtype))


def _check_geometry(H: int, W: int) -> None:
    if H % 8 or W % 8:
        raise ValueError(f"fused trunk needs H, W divisible by 8; got "
                         f"{(H, W)}")


# The bf16 conv kernel's tile (csrc/fused_trunk.cu, namespace tc): 8 rows
# x 16 columns of pixels, channels in steps of 64.
TC_TILE_H, TC_TILE_W, TC_CHANNELS = 8, 16, 64


def tc_fits(module, H: int, W: int) -> bool:
    """True when every conv from conv2 on fits the bf16 tensor-core
    kernel at an H x W input: its map's H a multiple of 8 and W of 16,
    its input and output channels multiples of 64."""
    h, w = H, W
    for i, (conv, pool) in enumerate(module.layers()):
        if i > 0 and (h % TC_TILE_H or w % TC_TILE_W
                      or conv.in_channels % TC_CHANNELS
                      or conv.out_channels % TC_CHANNELS):
            return False
        if pool:
            h, w = h // 2, w // 2
    return True


def fused_supported(module, pred: torch.Tensor) -> bool:
    """True when the trunk kernels take this (module, input) pair: one
    input channel, H and W divisible by 8 (three pools), 3x3 stride-1
    pad-1 convs chained channel to channel, widths divisible by 4 (vector
    loads), and a float32 or bfloat16 compute dtype; in bfloat16 also
    ``tc_fits`` (VGGish's widths at 128 x 128 fit)."""
    try:
        layers = module.layers()
    except AttributeError:
        return False
    if pred.ndim != 4 or pred.shape[3] != 1:
        return False
    if pred.shape[1] % 8 or pred.shape[2] % 8:
        return False
    cin = 1
    for conv, _ in layers:
        if (conv.in_channels != cin or conv.kernel_size != (3, 3)
                or conv.stride != (1, 1) or conv.padding != (1, 1)
                or conv.out_channels % 4):
            return False
        cin = conv.out_channels
    if module.dtype == torch.bfloat16:
        return tc_fits(module, pred.shape[1], pred.shape[2])
    return module.dtype in _DTYPES


def forward_weights(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """The forward conv kernel's weights in ``dtype``: bf16 [9, Cout, Cin]
    (K-major for the tensor cores), f32 [9, Cin, Cout] (the CUDA-core
    kernel's layout); tap = 3 ky + kx."""
    w = conv.weight.detach()
    if dtype == torch.bfloat16:
        w = w.permute(2, 3, 0, 1).reshape(9, conv.out_channels,
                                          conv.in_channels)
    else:
        w = w.permute(2, 3, 1, 0).reshape(9, conv.in_channels,
                                          conv.out_channels)
    return w.to(dtype).contiguous()


def dgrad_weights(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """The input-gradient kernel's weights in ``dtype``: [9, Cin, Cout],
    contracted over Cout with tap = 3 ky + kx taken at (-dy, -dx)."""
    w = conv.weight.detach().permute(2, 3, 1, 0)
    return w.reshape(9, conv.in_channels, conv.out_channels).to(
        dtype).contiguous()


def conv1_both(module, pred: torch.Tensor,
               target: torch.Tensor) -> torch.Tensor:
    """conv1 + ReLU on both branches: NHWC [B, H, W, 1] each -> f1 [2B, H,
    W, C1] in the module's dtype, pred rows first."""
    dt = module.dtype
    x = torch.cat([pred, target]).permute(0, 3, 1, 2)
    with exact_float32(x.device):
        f = conv_relu(x, module.conv1, dt)
    return f.permute(0, 2, 3, 1).contiguous()


def conv1_input_grad(module, g1: torch.Tensor) -> torch.Tensor:
    """d pred [B, H, W, 1] f32 from the (masked, scaled) gradient g1 [B,
    H, W, C1] at conv1's output: the transposed conv on dtype-rounded
    operands in exact f32."""
    dt = module.dtype
    w1 = module.conv1.weight
    with exact_float32(g1.device):
        d = F.conv_transpose2d(g1.permute(0, 3, 1, 2).to(dt).float(),
                               w1.to(dt).float(), padding=1)
    return d.permute(0, 2, 3, 1)


def fused_trunk_reference(module, f1: torch.Tensor, with_grad: bool = False
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of ``fused_trunk``: the trunk from f1 in plain
    PyTorch, the metrics by the plain normalized MSE, g1 by autograd."""
    _check_geometry(f1.shape[1], f1.shape[2])
    B = f1.shape[0] // 2
    with torch.set_grad_enabled(with_grad):
        x1 = f1.detach().float().requires_grad_(with_grad)
        x = x1.permute(0, 3, 1, 2)
        feats = [x] + module.feature_maps(F.max_pool2d(x, 2), start=1)
        m = torch.stack([normalized_mse_forward_reference(f[:B], f[B:])[0]
                         for f in feats], 1)
        if not with_grad:
            return m, None
        (g,) = torch.autograd.grad(m.mean(1).sum(), x1)
    g1 = torch.where(f1[:B] > 0, g[:B], torch.zeros_like(g[:B]))
    return m.detach(), g1.to(f1.dtype)


def build_fused_trunk() -> dict:
    """Compile csrc/fused_trunk.cu (ops/_build.py)."""
    return build_library("fused_trunk.cu")


@functools.cache
def _library():
    lib = ctypes.CDLL(build_fused_trunk()["path"])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.trunk_conv3x3.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    lib.trunk_conv3x3_dgrad.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.trunk_maxpool2.argtypes = [ptr] * 2 + [i32] * 5 + [ptr]
    lib.trunk_unpool2.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
    for fn in (lib.trunk_conv3x3, lib.trunk_conv3x3_dgrad,
               lib.trunk_maxpool2, lib.trunk_unpool2):
        fn.restype = ctypes.c_int
    return lib


def _ok(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"trunk {what} kernel launch failed: CUDA error "
                           f"{err}")


def trunk_conv(x: torch.Tensor, conv: nn.Conv2d,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conv + bias + ReLU of the trunk on the card: x [N, H, W, Cin]
    NHWC CUDA (f32 or bf16) -> y [N, H, W, Cout] in x's dtype; ``w`` is
    ``forward_weights(conv, x.dtype)`` (packed here when not given)."""
    n, h, wd, cin = x.shape
    if w is None:
        w = forward_weights(conv, x.dtype)
    bias = conv.bias.detach().float().contiguous()
    y = torch.empty((n, h, wd, conv.out_channels), dtype=x.dtype,
                    device=x.device)
    _ok(_library().trunk_conv3x3(
        x.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(),
        _DTYPES[x.dtype], n, h, wd, cin, conv.out_channels,
        torch.cuda.current_stream(x.device).cuda_stream), "conv")
    return y


def trunk_conv_dgrad(g: torch.Tensor, conv: nn.Conv2d,
                     w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv's input gradient on the card: g [N, H, W, Cout] NHWC CUDA
    in the dtype (f32 or bf16) -> dx [N, H, W, Cin] f32; ``w`` is
    ``dgrad_weights(conv, g.dtype)`` (packed here when not given)."""
    n, h, wd, cout = g.shape
    if w is None:
        w = dgrad_weights(conv, g.dtype)
    dx = torch.empty((n, h, wd, conv.in_channels), dtype=torch.float32,
                     device=g.device)
    _ok(_library().trunk_conv3x3_dgrad(
        g.data_ptr(), w.data_ptr(), dx.data_ptr(), _DTYPES[g.dtype], n, h,
        wd, conv.in_channels, cout,
        torch.cuda.current_stream(g.device).cuda_stream), "conv input-grad")
    return dx


def fused_trunk(module, f1: torch.Tensor, with_grad: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f1 [2B, H, W, C1] NHWC in the module's dtype (pred rows, then
    target rows) -> (m [B, 6] f32 per-layer per-sample metrics, g1 [B, H,
    W, C1] in the dtype, or None without grad).  CUDA tensors launch the
    trunk kernels; CPU tensors run the plain version."""
    if f1.device.type == "cpu":
        return fused_trunk_reference(module, f1, with_grad)
    if f1.device.type != "cuda":
        raise RuntimeError(f"fused_trunk: no kernel for {f1.device}")
    NB, H, W, C1 = f1.shape
    _check_geometry(H, W)
    dt = f1.dtype
    if dt != module.dtype or dt not in _DTYPES or C1 % 4 or NB % 2:
        raise ValueError(f"fused_trunk: f1 {dt} {tuple(f1.shape)} does not "
                         f"fit a {module.dtype} trunk")
    if dt == torch.bfloat16 and not tc_fits(module, H, W):
        raise ValueError(f"fused_trunk: the bf16 conv kernel needs channels "
                         f"in multiples of {TC_CHANNELS} and maps of whole "
                         f"{TC_TILE_H} x {TC_TILE_W} tiles; got a "
                         f"{(H, W)} input")
    lib = _library()
    code, B = _DTYPES[dt], NB // 2
    stream = torch.cuda.current_stream(f1.device).cuda_stream
    layers = module.layers()
    feats, stats, ms = [], [], []
    x = f1.contiguous()
    for i, (conv, pool) in enumerate(layers):
        if i > 0:
            x = trunk_conv(x, conv)
        m, st = normalized_mse_forward(x[:B], x[B:])
        ms.append(m)
        if with_grad:
            feats.append(x)
            stats.append(st)
        if pool and i + 1 < len(layers):
            n, h, w, c = x.shape
            y = torch.empty((n, h // 2, w // 2, c), dtype=dt, device=x.device)
            _ok(lib.trunk_maxpool2(x.data_ptr(), y.data_ptr(), code, n, h, w,
                                   c, stream), "max-pool")
            x = y
    m = torch.stack(ms, 1)
    g = None
    if with_grad:
        uscale = torch.full((B,), 1.0 / len(layers), dtype=torch.float32,
                            device=f1.device)
        for i in range(len(layers) - 1, -1, -1):
            f = feats[i]
            # in the dtype: the one rounding the conv input-gradient's
            # operand takes anyway
            g = normalized_mse_backward(
                f[:B], f[B:], stats[i], uscale, False, gin=g, mask=True,
                out_dtype=dt)
            if i == 0:
                break
            g = trunk_conv_dgrad(g, layers[i][0])
            if layers[i - 1][1]:
                prev = feats[i - 1][:B]
                up = torch.empty(prev.shape, dtype=torch.float32,
                                 device=f1.device)
                _ok(lib.trunk_unpool2(g.data_ptr(), prev.data_ptr(),
                                      up.data_ptr(), code, B, prev.shape[1],
                                      prev.shape[2], prev.shape[3], stream),
                    "unpool")
                g = up
    fused_trunk.launches += 1
    return m, g


fused_trunk.launches = 0


def _weighted(m: torch.Tensor, weights: torch.Tensor):
    m_bar = m.mean(1)
    w = weights.float()
    wsum = w.sum()
    return (m_bar * w).sum() / wsum, m_bar, w, wsum


class _FusedDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pred, target, weights, module):
        f1 = conv1_both(module, pred, target)
        m, g1 = fused_trunk(module, f1, with_grad=True)
        loss, m_bar, w, wsum = _weighted(m, weights)
        ctx.save_for_backward(g1, m_bar, w, wsum)
        ctx.module = module
        ctx.target_meta = (target.shape, target.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        g1, m_bar, w, wsum = ctx.saved_tensors
        need = ctx.needs_input_grad
        d_pred = d_target = d_w = None
        if need[0]:
            scale = (g * w / wsum)[:, None, None, None]
            d_pred = conv1_input_grad(ctx.module, g1.float() * scale)
        if need[1]:
            shape, dtype = ctx.target_meta
            d_target = torch.zeros(shape, dtype=dtype, device=g1.device)
        if need[2]:
            d_w = g * (m_bar * wsum - (m_bar * w).sum()) / wsum ** 2
        return d_pred, d_target, d_w, None


def fused_vggish_distance(module, pred: torch.Tensor, target: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """The VGGish distance of NHWC [B, H, W, 1] images with [B] weights,
    through the trunk kernels; gradients flow to ``pred`` and
    ``weights``, ``target`` gets zeros by design."""
    return _FusedDistance.apply(pred, target, weights, module)


def fused_vggish_distance_value(module, pred: torch.Tensor,
                                target: torch.Tensor,
                                weights: torch.Tensor) -> torch.Tensor:
    """The distance only: the trunk kernels without the backward chain
    and without keeping any map it needs; no gradient."""
    with torch.no_grad():
        f1 = conv1_both(module, pred, target)
        m, _ = fused_trunk(module, f1, with_grad=False)
        return _weighted(m, weights)[0]


def fused_vggish_distance_reference(module, pred: torch.Tensor,
                                    target: torch.Tensor,
                                    weights: torch.Tensor) -> torch.Tensor:
    """Plain version of the distance: the trunk in plain PyTorch and the
    plain normalized MSE per layer (autograd reaches pred and target)."""
    from music_style_transfer_ldm_tpu_torch.losses.vggish import (
        vggish_feature_distance,   # imports this module
    )
    return vggish_feature_distance(module, pred, target, weights, "plain")


def trunk_cost(module, batch: int, H: int, W: int, itemsize: int,
               with_grad: bool) -> dict:
    """Work of one ``fused_trunk`` call: 'flops' (2 per multiply-add of
    conv2 ... conv4_2 on both branches, plus their input gradients on the
    pred branch with grad) and 'bytes' (f1 and the weights read once, m
    and g1 written once)."""
    flops, wbytes = 0, 0
    h, w = H, W
    layers = module.layers()
    for i, (conv, pool) in enumerate(layers):
        if i > 0:
            macs = 9 * conv.in_channels * conv.out_channels * h * w
            flops += 2 * macs * (3 if with_grad else 2)
            wbytes += 9 * conv.in_channels * conv.out_channels * itemsize
        if pool:
            h, w = h // 2, w // 2
    c1 = layers[0][0].out_channels
    f1_bytes = 2 * batch * H * W * c1 * itemsize
    out_bytes = 24 * batch + (batch * H * W * c1 * itemsize
                              if with_grad else 0)
    return {"flops": flops * batch,
            "bytes": f1_bytes + wbytes + out_bytes}
