"""The whole sampling trajectory as one CUDA kernel (kernel A).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/fused_sampler.py``
``fused_ddim_sample``.  ``pack_operands`` folds everything that is not
the latent into the kernel's operands, as the JAX package does:

* the weights of the nine convs and the four attention projections
  (q and out of s5 and s6), each as a [Cout, K] matrix (K = tap-major
  3x3 x Cin, or Cin for a projection) cut into 16-row tiles and stored
  in the fragment order of ``mma.sync.m16n8k16``'s A operand, all in one
  flat tensor; the biases in another (``unpack`` gives back the module
  layout, and the plain version reads the weights through it);
* the per-step time-embedding rows (sinusoid -> fc1 -> tanh-GELU ->
  fc2), computed here in plain PyTorch;
* the per-element K/V projections of s5 and s6, in plain PyTorch;
* the per-step update scalars (A, B, C, P, Q), folded on the host from
  the schedule's numpy copy for DDIM (with eta) and DPM-Solver++(2M):
      x <- A x + B eps + C prev,   prev <- P x + Q eps.

``fused_ddim_sample`` runs the trajectory: on a CUDA tensor the kernel in
``csrc/fused_sampler.cu`` (built with nvcc at first use, bound with
ctypes), on a CPU tensor ``reference_ddim_sample``, the plain PyTorch
version of the same packed math (F.conv2d / conv_transpose2d, attention
and the folded update, rounded to the working type where the kernel
rounds).

The kernel is one cooperative launch over a grid of the card's SM count.
``launch_plan`` decides which block holds which weight tiles (a tile is
16 output channels of one layer; small layers are replicated, each
replica taking every R-th batch element) and how many elements a block
stages per pass; the CUDA source explains the design.  The kernel's
dependency floor at small B is its grid barriers: 15 per UNet step, 735
per 49-step trajectory.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (
    generation_time_grid, transfer_time_grid,
)
from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import seeded_noise
from music_style_transfer_ldm_tpu_torch.ops._build import build_library
from music_style_transfer_ldm_tpu_torch.utils.profiling import active, span

_H = 16
_LAT = 32
_NF = 64
_N_HEADS = 4
_TILE = 16          # output channels per weight tile (mma's M)
_KIND = {"s1": 0, "s2": 1, "T": 2, "p": 3}
# The packed layers in execution order: (name, module, kind, Cin, Cout,
# input side, output side, input buffer, output buffer, skip buffer).
# kind 's1' / 's2' = k3 conv stride 1 / 2, 'T' = k3 s2 transpose conv
# (p1, output_padding 1), 'p' = an attention projection (one tap).
_LAYERS = (
    ("enc1", "enc1", "s1", 32, 64, 16, 16, "x", "z1", None),
    ("enc2", "enc2", "s2", 64, 128, 16, 8, "z1", "z2", None),
    ("enc3", "enc3", "s2", 128, 256, 8, 4, "z2", "z3", None),
    ("q5", "cross_attention2.q_proj", "p", 256, 256, 4, 4, "z3", "q", None),
    ("o5", "cross_attention2.out_proj", "p", 256, 256, 4, 4, "att", "z3a",
     None),
    ("enc4", "enc4", "s2", 256, 512, 4, 2, "z3a", "z4", None),
    ("q6", "cross_attention1.q_proj", "p", 512, 512, 2, 2, "z4", "q", None),
    ("o6", "cross_attention1.out_proj", "p", 512, 512, 2, 2, "att", "z4a",
     None),
    ("bottleneck", "bottleneck", "s1", 512, 512, 2, 2, "z4a", "zb", None),
    ("dec4", "dec4", "T", 512, 256, 2, 4, "zb", "u3", "z3"),
    ("dec3", "dec3", "T", 256, 128, 4, 8, "u3", "u2", "z2"),
    ("dec2", "dec2", "T", 128, 64, 8, 16, "u2", "u1", "z1"),
    ("dec1", "dec1", "s1", 64, 32, 16, 16, "u1", "eps", None),
)
_NAMES = tuple(layer[0] for layer in _LAYERS)
# Cross-attention: (module, style key, query rows, channels, keys).
_ATTN = (("cross_attention2", "s5", 16, 256, 16),
         ("cross_attention1", "s6", 4, 512, 4))
# One UNet step: a layer index, or -1 - a for attention a's core.
_PHASES = (0, 1, 2, 3, -1, 4, 5, 6, -2, 7, 8, 9, 10, 11, 12)
# Activation buffers of the workspace: elements of the working type per
# batch element (q and att hold s5's [16, 256] or s6's [4, 512]).
_BUFFERS = (("z1", 16384), ("z2", 8192), ("z3", 4096), ("q", 4096),
            ("att", 4096), ("z3a", 4096), ("z4", 2048), ("z4a", 2048),
            ("zb", 2048), ("u3", 4096), ("u2", 8192), ("u1", 16384))
# Per layer: the split of K over warps (fixed, so a sum's order does
# not depend on B) and the replicas of each tile.
_KSPLIT = dict(enc1=2, enc2=4, enc3=8, q5=8, o5=8, enc4=16, q6=16, o6=16,
               bottleneck=16, dec4=8, dec3=4, dec2=2, dec1=2)
_REPLICAS = dict(enc1=8, enc2=8, enc3=2, q5=2, o5=2, enc4=1, q6=1, o6=1,
                 bottleneck=1, dec4=1, dec3=4, dec2=8, dec1=8)
# Shared memory a block keeps for staging activations and partial sums,
# and the mma items of a pass: one per warp, each a k-part of a group of
# four 8-column tiles.
_SCRATCH_BYTES = {torch.bfloat16: 72 * 1024, torch.float32: 160 * 1024}
_MAX_ITEMS = 16
_GROUP = 4
_MAX_OUTPUTS = 8 * 512  # bf16: eight epilogue outputs per thread
_STATIC_SMEM = 3072     # the kernel's static shared memory, rounded up
_MAX_SLOTS = len(_LAYERS)

# Largest batch the kernel takes (the JAX package's limit, so both route
# the same buckets).
FUSED_MAX_BATCH = 8


@dataclasses.dataclass
class FusedOperands:
    """Packed operands of one trajectory (everything but the latents)."""

    weights: torch.Tensor             # flat, tile-major fragment order
    biases: torch.Tensor              # flat, layer by layer
    kv: List[torch.Tensor]            # [k5, v5, k6, v6], each [B, Tk, C]
    temb: torch.Tensor                # [S-1, 128], working type
    coefs: torch.Tensor               # [S-1, 5], f32
    dtype: torch.dtype
    batch: int


def _taps(kind: str) -> int:
    return 1 if kind == "p" else 9


def _layer_sizes():
    """Per layer (weight elements, bias elements), in _LAYERS order."""
    return [(_taps(k) * cin * cout, cout)
            for _, _, k, cin, cout, *_ in _LAYERS]


def _offsets(sizes):
    out, acc = [], 0
    for s in sizes:
        out.append(acc)
        acc += s
    return out, acc


def check_geometry(unet) -> None:
    """The kernel is written for the flagship geometry only."""
    shape = tuple(unet.enc1.weight.shape)
    if shape != (_NF, _LAT, 3, 3):
        raise ValueError(
            "fused sampler supports the flagship UNet geometry "
            f"(latent_dim={_LAT}, num_filters={_NF}); got enc1 weight "
            f"{shape} — use the scan samplers (models/ldm.py) for other "
            "widths")


def step_coefficients(schedule: DiffusionSchedule, times: np.ndarray,
                      eta: float, sampler: str) -> np.ndarray:
    """Per-step update scalars [S-1, 5] = (A, B, C, P, Q), float32.

    prev (P x + Q eps) is the x0 estimate from the OLD x; DDIM has C = 0,
    DPM-Solver++(2M) carries its multistep history through C."""
    times = np.asarray(times)
    ab = schedule.alpha_bars_np
    ab_t, ab_n = ab[times[:-1]], ab[times[1:]]
    sq_t, sq_n = np.sqrt(ab_t), np.sqrt(ab_n)
    s1m_t, s1m_n = np.sqrt(1.0 - ab_t), np.sqrt(1.0 - ab_n)
    P = 1.0 / sq_t
    Q = -s1m_t / sq_t
    if sampler == "ddim":
        A = sq_n / sq_t
        B = -sq_n * s1m_t / sq_t + (1.0 + eta) * s1m_n - eta * s1m_t
        C = np.zeros_like(A)
    elif sampler == "dpm++":
        if eta:
            raise ValueError("dpm++ is deterministic; eta must be 0")
        if len(np.unique(times)) != len(times):
            raise ValueError("duplicate timesteps in the grid: zero "
                             "log-SNR step h (use steps <= num_timesteps)")
        lam = np.log(sq_t / s1m_t)
        h = np.log(sq_n / s1m_n) - lam
        prev_lam = np.concatenate([lam[:1], lam[:-1]])
        first = np.arange(len(h)) == 0
        r = np.where(first, np.float32(1.0), (lam - prev_lam) / h)
        E = -sq_n * np.expm1(-h)
        c2 = np.where(first, E, E * (1.0 + 1.0 / (2.0 * r)))
        C = np.where(first, np.float32(0.0), -E / (2.0 * r))
        A = s1m_n / s1m_t + c2 * P
        B = c2 * Q
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return np.stack([A, B, C, P, Q], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Weight layout: [Cout, K] matrices in mma fragment order
# ---------------------------------------------------------------------------
#
# mma.sync.m16n8k16's A operand (16 x 16, row-major) sits in four 32-bit
# registers per lane: lane = 4 g + t holds rows g and g + 8 and columns
# 2t, 2t + 1, 2t + 8, 2t + 9 as reg0 = (g, 2t..), reg1 = (g + 8, 2t..),
# reg2 = (g, 2t + 8..), reg3 = (g + 8, 2t + 8..).  A tile [16, K] is
# stored per 16-column k-step as [lane][reg][2] = [g][t][kh][rh][pos]
# (m = g + 8 rh, k = 16 s + 8 kh + 2 t + pos), so each lane reads its
# fragment as one 16-byte word.

def _module_matrix(weight: torch.Tensor, kind: str) -> torch.Tensor:
    """Module weight -> [Cout, K], K = (ky, kx, Cin) for the convs."""
    if kind == "p":                    # Linear [out, in]
        return weight
    if kind == "T":                    # ConvTranspose2d [I, O, kh, kw]
        return weight.permute(1, 2, 3, 0).reshape(weight.shape[1], -1)
    return weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)


def _matrix_to_module(mat: torch.Tensor, kind: str, cin: int):
    if kind == "p":
        return mat
    cout = mat.shape[0]
    w = mat.reshape(cout, 3, 3, cin)
    return w.permute(3, 0, 1, 2) if kind == "T" else w.permute(0, 3, 1, 2)


def pack_tiles(mat: torch.Tensor) -> torch.Tensor:
    """[Cout, K] -> flat [Cout / 16 tiles][K / 16 steps][8 g][4 t][2 kh]
    [2 rh][2 pos]."""
    cout, k = mat.shape
    w = mat.reshape(cout // _TILE, 2, 8, k // 16, 2, 4, 2)
    #                  tile,   rh,  g,   s,     kh, t, pos
    return w.permute(0, 3, 2, 5, 4, 1, 6).reshape(-1)


def unpack_tiles(flat: torch.Tensor, cout: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_tiles``."""
    w = flat.reshape(cout // _TILE, k // 16, 8, 4, 2, 2, 2)
    #                  tile,        s,      g, t, kh, rh, pos
    return w.permute(0, 5, 2, 1, 4, 3, 6).reshape(cout, k)


def unpack(ops: FusedOperands) -> Dict[str, tuple]:
    """{layer name: (weight, bias)} in the modules' own layouts (Conv2d
    [O, I, 3, 3], ConvTranspose2d [I, O, 3, 3], Linear [out, in]) and the
    working type, read back from the packed operands."""
    sizes = _layer_sizes()
    w_off, _ = _offsets([s for s, _ in sizes])
    b_off, _ = _offsets([c for _, c in sizes])
    out = {}
    for j, (name, _, kind, cin, cout, *_) in enumerate(_LAYERS):
        flat = ops.weights[w_off[j]:w_off[j] + sizes[j][0]]
        mat = unpack_tiles(flat, cout, sizes[j][0] // cout)
        out[name] = (_matrix_to_module(mat, kind, cin),
                     ops.biases[b_off[j]:b_off[j] + cout])
    return out


@torch.no_grad()
def pack_operands(unet, style_embedding: Dict[str, torch.Tensor],
                  schedule: DiffusionSchedule, times: np.ndarray,
                  eta: float, sampler: str = "ddim",
                  batch: int = 1) -> FusedOperands:
    """Build the kernel operands from the UNet module and the style
    pyramid (NHWC maps, the JAX layout; s5 and s6 are read).  One style
    with batch > 1 is shared by every element."""
    if batch > FUSED_MAX_BATCH:
        raise ValueError(f"batched fused sampler packs at most "
                         f"B={FUSED_MAX_BATCH}; got {batch}")
    check_geometry(unet)
    dt = unet.enc1.weight.dtype
    dev = unet.enc1.weight.device
    coefs = step_coefficients(schedule, times, eta, sampler)
    t_grid = torch.as_tensor(np.asarray(times[:-1]), dtype=torch.int32,
                             device=dev)
    temb = unet.time_embedding(t_grid).to(dt).contiguous()

    weights, biases = [], []
    for _, path, kind, *_ in _LAYERS:
        mod = unet.get_submodule(path)
        weights.append(pack_tiles(_module_matrix(mod.weight.to(dt), kind)))
        biases.append(mod.bias.to(dt))

    kv = []
    for name, skey, *_ in _ATTN:
        mod = getattr(unet, name)
        s = style_embedding[skey].to(device=dev, dtype=dt)
        if s.shape[0] == 1 and batch > 1:
            s = s.expand(batch, *s.shape[1:])
        if s.shape[0] != batch:
            raise ValueError(f"style embedding batch {s.shape[0]} != "
                             f"kernel batch {batch}")
        tokens = s.reshape(batch, -1, s.shape[-1])      # NHWC -> [B, Tk, C]
        kv += [F.linear(tokens, mod.k_proj.weight, mod.k_proj.bias)
               .to(dt).contiguous(),
               F.linear(tokens, mod.v_proj.weight, mod.v_proj.bias)
               .to(dt).contiguous()]
    return FusedOperands(torch.cat(weights).contiguous(),
                         torch.cat(biases).contiguous(), kv, temb,
                         torch.as_tensor(coefs, device=dev), dt, batch)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _attention_reference(z, wq, bq, k, v, wo, bo, rnd):
    """z [B, C, H, W] f32 (values of the working type) -> [B, C, H, W];
    wq, wo in Linear layout [out, in]."""
    B, C, H, W = z.shape
    hd = C // _N_HEADS
    q = rnd(z.flatten(2).transpose(1, 2) @ wq.float().t() + bq.float())
    q = q.reshape(B, H * W, _N_HEADS, hd)
    kh = k.float().reshape(B, -1, _N_HEADS, hd)
    vh = v.float().reshape(B, -1, _N_HEADS, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kh) * (1.0 / math.sqrt(hd))
    p = rnd(torch.softmax(logits, dim=-1))
    att = rnd(torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, H * W, C))
    out = att @ wo.float().t() + bo.float()
    return out.transpose(1, 2).reshape(B, C, H, W)


def _unet_step_reference(x, ops: FusedOperands, i: int, w: Dict):
    """One UNet forward on f32 latents x [B, 32, 16, 16] -> eps f32; w is
    ``unpack(ops)`` in f32."""
    def rnd(a):
        return a.to(ops.dtype).float()

    def conv(name, a):
        kind = _LAYERS[_NAMES.index(name)][2]
        wt, b = w[name]
        if kind == "T":
            return F.conv_transpose2d(a, wt, b, stride=2, padding=1,
                                      output_padding=1)
        return F.conv2d(a, wt, b, stride=2 if kind == "s2" else 1,
                        padding=1)

    def attention(name_q, name_o, z, k, v):
        return _attention_reference(z, *w[name_q], k, v, *w[name_o], rnd)

    temb = ops.temb[i].float()[None, :, None, None]
    k5, v5, k6, v6 = ops.kv
    z1 = rnd(torch.relu(conv("enc1", rnd(x))))
    z2 = rnd(torch.relu(conv("enc2", z1)) + temb)
    z3 = rnd(torch.relu(conv("enc3", z2)))
    z3a = rnd(attention("q5", "o5", z3, k5, v5))
    z4 = rnd(torch.relu(conv("enc4", z3a)))
    z4a = rnd(attention("q6", "o6", z4, k6, v6))
    zb = rnd(torch.relu(conv("bottleneck", z4a)))
    u3 = rnd(torch.relu(conv("dec4", zb)) + z3)
    u2 = rnd(torch.relu(conv("dec3", u3)) + z2)
    u1 = rnd(torch.relu(conv("dec2", u2)) + z1)
    return conv("dec1", u1)


@torch.no_grad()
def reference_ddim_sample(ops: FusedOperands, z_t: torch.Tensor,
                          n_steps: int) -> torch.Tensor:
    """Plain PyTorch executor of the packed math: z_t [B, 16, 16, 32]
    (NHWC) -> final latents, f32 NHWC."""
    w = {k: (a.float(), b.float()) for k, (a, b) in unpack(ops).items()}
    x = z_t.float().permute(0, 3, 1, 2)
    prev = torch.zeros_like(x)
    coefs = ops.coefs.cpu().numpy()
    for i in range(n_steps):
        eps = _unet_step_reference(x, ops, i, w)
        A, B, C, P, Q = (float(c) for c in coefs[i])
        x, prev = A * x + B * eps + C * prev, P * x + Q * eps
    return x.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# The launch plan: which block holds which tiles
# ---------------------------------------------------------------------------


def _elem_size(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _pass_bytes(j: int, g: int, dtype) -> tuple:
    """(staging bytes, partial-sum bytes, mma items) of a pass of layer j
    over g batch elements."""
    name, _, kind, cin, _, hin, hout, *_ = _LAYERS[j]
    es = _elem_size(dtype)
    stage = g * hin * hin * (cin + 16 // es) * es
    if dtype != torch.bfloat16:        # f32: one thread, one whole sum
        return stage, 0, 0
    ntiles = -(-g * hout * hout // 8)
    return stage, _KSPLIT[name] * _TILE * (ntiles * 8 + 2) * 4, \
        _KSPLIT[name] * -(-ntiles // _GROUP)


def _fits(j: int, g: int, dtype) -> bool:
    stage, part, items = _pass_bytes(j, g, dtype)
    outputs = g * _LAYERS[j][6] ** 2 * _TILE
    return (max(stage, part) <= _SCRATCH_BYTES[dtype] and items <= _MAX_ITEMS
            and (dtype != torch.bfloat16 or outputs <= _MAX_OUTPUTS))


def _group(j: int, dtype) -> int:
    """Batch elements a block stages per pass of layer j."""
    if not _fits(j, 1, dtype):
        raise ValueError(f"layer {_NAMES[j]}: one element does not fit "
                         "a pass")
    g = 1
    while g < FUSED_MAX_BATCH and _fits(j, g + 1, dtype):
        g += 1
    return g


@functools.lru_cache(maxsize=None)
def launch_plan(n_blocks: int, smem_limit: int, dtype) -> dict:
    """Map every (layer, tile, replica) slot to one block, biggest first,
    each to the block with the most room that holds no slot of that
    layer yet, so a phase's tiles run on distinct blocks.

    bf16 keeps its slots' weights in shared memory for the whole launch;
    f32 reads its weights through L2 and only balances slot counts.
    Returns {'slots': [[(layer, tile, replica, smem offset), ...] per
    block], 'groups', 'scratch_off', 'smem_bytes', 'weight_bytes' (per
    block)}."""
    in_smem = dtype == torch.bfloat16
    scratch = _SCRATCH_BYTES[dtype]
    room = smem_limit - scratch - _STATIC_SMEM
    slots = []
    for j, (name, _, kind, cin, cout, *_) in enumerate(_LAYERS):
        nbytes = _taps(kind) * cin * _TILE * 2 if in_smem else 0
        for tile in range(cout // _TILE):
            for rep in range(_REPLICAS[name]):
                slots.append((nbytes, j, tile, rep))
    slots.sort(key=lambda s: (-s[0], s[1], s[2], s[3]))
    used = [0] * n_blocks
    count = [0] * n_blocks
    held = [set() for _ in range(n_blocks)]
    plan = [[] for _ in range(n_blocks)]
    for nbytes, j, tile, rep in slots:
        free = [b for b in range(n_blocks)
                if j not in held[b] and used[b] + nbytes <= room]
        if not free:
            raise RuntimeError(
                f"fused sampler: the weight tiles do not fit {n_blocks} "
                f"blocks of {smem_limit} bytes of shared memory")
        b = min(free, key=lambda b: (used[b], count[b], b))
        plan[b].append((j, tile, rep, used[b]))
        used[b] += nbytes
        count[b] += 1
        held[b].add(j)
    for p in plan:
        p.sort()
    scratch_off = -(-max(used) // 128) * 128
    return {"slots": plan,
            "groups": tuple(_group(j, dtype) for j in range(len(_LAYERS))),
            "scratch_off": scratch_off,
            "smem_bytes": scratch_off + scratch,
            "weight_bytes": used}


def workspace_layout(batch: int) -> Dict[str, int]:
    """Offsets (elements of the working type) of the activation buffers
    in the workspace, B-major within each buffer, and 'total'."""
    out, acc = {}, 0
    for name, per in _BUFFERS:
        out[name] = acc
        acc += batch * per
    out["total"] = acc
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


class _LayerDesc(ctypes.Structure):
    """Mirror of ``struct LayerDesc`` in csrc/fused_sampler.cu."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "kind", "cin", "cout", "hin", "hout", "replicas", "group", "ksplit",
        "w_off", "b_off", "in_off", "out_off", "skip_off", "temb", "relu",
        "eps_out")]


class _AttnDesc(ctypes.Structure):
    """Mirror of ``struct AttnDesc``."""

    _fields_ = [(f, ctypes.c_int) for f in (
        "q_off", "att_off", "rows", "channels", "keys", "kv", "pad0",
        "pad1")]


class _SamplerArgs(ctypes.Structure):
    """Mirror of ``struct SamplerArgs``."""

    _fields_ = [("weights", ctypes.c_void_p),
                ("biases", ctypes.c_void_p),
                ("kv", ctypes.c_void_p * 4),
                ("temb", ctypes.c_void_p),
                ("coefs", ctypes.c_void_p),
                ("x_in", ctypes.c_void_p),
                ("x_out", ctypes.c_void_p),
                ("workspace", ctypes.c_void_p),
                ("prev", ctypes.c_void_p),
                ("barrier", ctypes.c_void_p),
                ("plan", ctypes.c_void_p),
                ("layers", _LayerDesc * len(_LAYERS)),
                ("attn", _AttnDesc * 2),
                ("phases", ctypes.c_int * len(_PHASES)),
                ("n_steps", ctypes.c_int),
                ("batch", ctypes.c_int),
                ("scratch_off", ctypes.c_int),
                ("smem_bytes", ctypes.c_int)]


def build_fused_sampler() -> dict:
    """Compile csrc/fused_sampler.cu (ops/_build.py).  Returns {'path',
    'seconds', 'log'}."""
    return build_library("fused_sampler.cu")


@functools.cache
def _library():
    lib = ctypes.CDLL(build_fused_sampler()["path"])
    lib.fused_sampler_args_size.argtypes = []
    lib.fused_sampler_args_size.restype = ctypes.c_size_t
    lib.fused_sampler_device_limits.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.fused_sampler_device_limits.restype = ctypes.c_int
    lib.fused_ddim_sample.argtypes = [ctypes.POINTER(_SamplerArgs),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.fused_ddim_sample.restype = ctypes.c_int
    if lib.fused_sampler_args_size() != ctypes.sizeof(_SamplerArgs):
        raise RuntimeError("SamplerArgs layout differs between the CUDA "
                           "source and its ctypes mirror")
    return lib


@functools.cache
def device_plan(device_index: int, dtype) -> dict:
    """The launch plan for a card: its SM count and its opt-in shared
    memory per block, read with cudaGetDeviceProperties."""
    lib = _library()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    err = lib.fused_sampler_device_limits(device_index, ctypes.byref(sms),
                                          ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"fused sampler: cudaGetDeviceProperties failed "
                           f"with CUDA error {err}")
    plan = dict(launch_plan(sms.value, smem.value, dtype))
    table = torch.full((sms.value, _MAX_SLOTS, 4), -1, dtype=torch.int32)
    for b, slots in enumerate(plan["slots"]):
        for i, slot in enumerate(slots):
            table[b, i] = torch.tensor(slot, dtype=torch.int32)
    plan.update(n_blocks=sms.value, smem_limit=smem.value,
                table=table.to(torch.device("cuda", device_index)))
    return plan


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _descriptors(args: _SamplerArgs, plan: dict, batch: int) -> None:
    ws = workspace_layout(batch)
    sizes = _layer_sizes()
    w_off, _ = _offsets([s for s, _ in sizes])
    b_off, _ = _offsets([c for _, c in sizes])
    for j, (name, _, kind, cin, cout, hin, hout, src, dst, skip) in \
            enumerate(_LAYERS):
        d = args.layers[j]
        d.kind, d.cin, d.cout, d.hin, d.hout = _KIND[kind], cin, cout, hin, \
            hout
        d.replicas, d.group, d.ksplit = (_REPLICAS[name], plan["groups"][j],
                                         _KSPLIT[name])
        d.w_off, d.b_off = w_off[j], b_off[j]
        d.in_off = -1 if src == "x" else ws[src]
        d.out_off = -1 if dst == "eps" else ws[dst]
        d.skip_off = -1 if skip is None else ws[skip]
        d.temb = int(name == "enc2")
        d.relu = int(name != "dec1" and kind != "p")
        d.eps_out = int(dst == "eps")
    for a, (_, _, rows, channels, keys) in enumerate(_ATTN):
        d = args.attn[a]
        d.q_off, d.att_off, d.rows, d.channels, d.keys, d.kv = (
            ws["q"], ws["att"], rows, channels, keys, 2 * a)
    for i, p in enumerate(_PHASES):
        args.phases[i] = p


def _launch(ops: FusedOperands, z_t: torch.Tensor, n_steps: int):
    if ops.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel supports float32 and bfloat16, not "
                         f"{ops.dtype}")
    if n_steps > ops.coefs.shape[0]:
        raise ValueError(f"n_steps={n_steps} > packed steps "
                         f"{ops.coefs.shape[0]}")
    for t in [ops.weights, ops.biases, ops.temb] + list(ops.kv):
        if (t.device != z_t.device or t.dtype != ops.dtype
                or not t.is_contiguous()):
            raise ValueError("packed operands must be contiguous "
                             f"{ops.dtype} tensors on {z_t.device}")
    lib = _library()
    dev = z_t.device
    plan = device_plan(dev.index if dev.index is not None
                       else torch.cuda.current_device(), ops.dtype)
    B = z_t.shape[0]
    x_in = z_t.float().contiguous()
    out = torch.empty_like(x_in)
    coefs = ops.coefs.to(device=dev, dtype=torch.float32).contiguous()
    ws = torch.empty(workspace_layout(B)["total"], dtype=ops.dtype,
                     device=dev)
    prev = torch.empty_like(x_in)
    barrier = torch.empty(1, dtype=torch.int32, device=dev)  # zeroed by C
    args = _SamplerArgs()
    args.weights = ops.weights.data_ptr()
    args.biases = ops.biases.data_ptr()
    for j in range(4):
        args.kv[j] = ops.kv[j].data_ptr()
    args.temb = ops.temb.data_ptr()
    args.coefs = coefs.data_ptr()
    args.x_in = x_in.data_ptr()
    args.x_out = out.data_ptr()
    args.workspace = ws.data_ptr()
    args.prev = prev.data_ptr()
    args.barrier = barrier.data_ptr()
    args.plan = plan["table"].data_ptr()
    _descriptors(args, plan, B)
    args.n_steps = n_steps
    args.batch = B
    args.scratch_off = plan["scratch_off"]
    args.smem_bytes = plan["smem_bytes"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with span("kernel_a", device=dev, batch=B, n_steps=n_steps) as sp:
        with torch.cuda.device(dev):      # the C launch targets this device
            err = lib.fused_ddim_sample(ctypes.byref(args),
                                        _DTYPE_CODE[ops.dtype],
                                        plan["n_blocks"], stream)
    if active() is not None:
        sp.set(**trajectory_cost(ops, n_steps))
    if err != 0:
        raise RuntimeError(f"fused sampler: the cooperative launch of "
                           f"{plan['n_blocks']} blocks with "
                           f"{plan['smem_bytes']} bytes of shared memory "
                           f"each was refused: CUDA error {err}")
    fused_ddim_sample.launches += 1
    return out


def fused_ddim_sample(ops: FusedOperands, z_t: torch.Tensor,
                      n_steps: int) -> torch.Tensor:
    """Run the trajectory: z_t [B, 16, 16, 32] NHWC (B as packed) ->
    final latents, f32 NHWC.  CUDA tensors launch the kernel; CPU tensors
    run the plain version."""
    if tuple(z_t.shape[1:]) != (_H, _H, _LAT) or z_t.shape[0] != ops.batch:
        raise ValueError(f"z_t {tuple(z_t.shape)} does not match the packed "
                         f"batch {ops.batch} x {_H}x{_H}x{_LAT}")
    if z_t.device.type == "cpu":
        return reference_ddim_sample(ops, z_t, n_steps)
    if z_t.device.type != "cuda":
        raise RuntimeError(f"fused_ddim_sample: no kernel for {z_t.device}")
    return _launch(ops, z_t, n_steps)


fused_ddim_sample.launches = 0


def trajectory_cost(ops: FusedOperands, n_steps: int) -> dict:
    """Work of one trajectory, from the packed shapes: 'flops' (2 per
    multiply-add: nine dense 3x3 convs and two attentions per element-
    step) and 'bytes' (every packed operand read once, the f32 latents
    read and written once)."""
    macs = 0
    for name, _, kind, cin, cout, hin, hout, *_ in _LAYERS:
        if kind == "p":
            continue
        # A transpose conv's 9 taps act on its input pixels.
        px = hin * hin if kind == "T" else hout * hout
        macs += 9 * cin * cout * px
    for (_, _, m, c, _), k in zip(_ATTN, ops.kv[::2]):
        macs += 2 * m * c * c + 2 * m * k.shape[1] * c
    tensors = [ops.weights, ops.biases, ops.temb, ops.coefs] + list(ops.kv)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    nbytes += 2 * ops.batch * _H * _H * _LAT * 4
    return {"flops": 2 * macs * n_steps * ops.batch, "bytes": nbytes}


@torch.no_grad()
def fused_style_sample(ldm, z_shape, style: torch.Tensor,
                       timesteps: int = 100, eta: float = 0.0,
                       sampler: str = "ddim",
                       noise: torch.Tensor | None = None,
                       seed: int = 0) -> torch.Tensor:
    """Style-conditioned generation from noise with the whole trajectory
    as one kernel launch: the grid and update of
    ``models.ldm.style_ddim_sample`` (``generation_time_grid``).

    z_shape is NHWC [B, 16, 16, 32], B <= FUSED_MAX_BATCH; style is NHWC
    [1 or B, 128, 128, 1].  ``noise`` (NHWC) is the draw as given;
    otherwise one generator seeded by ``seed`` draws it.  Returns decoded
    images in [0, 1], NHWC f32."""
    if z_shape[0] > FUSED_MAX_BATCH:
        raise ValueError(f"fused sampler packs at most B={FUSED_MAX_BATCH}"
                         f"; got batch {z_shape[0]} — use the scan "
                         "samplers (models/ldm.py) for larger batches")
    dev = ldm.device
    if noise is None:
        noise = seeded_noise(z_shape, seed, dev)
    times = generation_time_grid(ldm.num_timesteps, timesteps)
    ops = pack_operands(ldm.unet, ldm.style_embed(style.to(dev)),
                        ldm.schedule, times, eta, sampler=sampler,
                        batch=z_shape[0])
    sampled = fused_ddim_sample(ops, noise.to(device=dev,
                                              dtype=torch.float32),
                                len(times) - 1)
    return ldm.decode_unit(sampled.permute(0, 3, 1, 2))


@torch.no_grad()
def fused_content_style_transfer(ldm, content: torch.Tensor,
                                 style: torch.Tensor,
                                 num_timesteps: int = 50, eta: float = 0.0,
                                 sampler: str = "ddim",
                                 steps: int | None = None,
                                 noise: torch.Tensor | None = None,
                                 seeds=0) -> torch.Tensor:
    """SDEdit transfer with the whole trajectory as one kernel launch.

    Same trajectory as ``models.ldm.content_style_transfer``; content and
    style are NHWC [B, 128, 128, 1], one style per element.  ``noise``
    [B, 16, 16, 32] overrides the per-item generators seeded by ``seeds``.
    Returns decoded images in [0, 1], NHWC f32.  Traced as ``ldm.encode``,
    ``ldm.style``, ``ldm.pack``, ``ldm.sample`` (around kernel A's call,
    whose launch is ``kernel_a``) and ``ldm.decode``, the last two on the
    device too."""
    if content.shape[0] > FUSED_MAX_BATCH:
        raise ValueError(f"fused sampler packs at most B={FUSED_MAX_BATCH}"
                         f"; got batch {content.shape[0]} — use the scan "
                         "samplers (models/ldm.py) for larger batches")
    dev = ldm.device
    with span("ldm.encode"):
        z_t = ldm.noised_latents(content, num_timesteps, noise, seeds)
    with span("ldm.style"):
        emb = ldm.style_embed(style)
    times = transfer_time_grid(num_timesteps, steps)
    with span("ldm.pack"):
        ops = pack_operands(ldm.unet, emb, ldm.schedule, times, eta,
                            sampler=sampler, batch=content.shape[0])
    with span("ldm.sample", device=dev):
        sampled = fused_ddim_sample(ops, z_t.permute(0, 2, 3, 1),
                                    len(times) - 1)
    with span("ldm.decode", device=dev):
        return ldm.decode_unit(sampled.permute(0, 3, 1, 2))
