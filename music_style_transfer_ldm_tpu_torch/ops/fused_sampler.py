"""The whole sampling trajectory as one CUDA kernel (kernel A).

Replaces ``music_style_transfer_ldm_tpu/ops/pallas/fused_sampler.py``
``fused_ddim_sample``.  ``pack_operands`` folds everything that is not
the latent into the kernel's operands, as the JAX package does:

* the conv weights, packed tap-major [kh, kw, Cin, Cout] (the CUDA
  source explains why), and the dense weights as [in, out];
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

_H = 16
_LAT = 32
_NF = 64
_N_HEADS = 4
# (name, kind) in execution order; kind 's1' / 's2' = k3 conv stride 1 / 2,
# 'T' = k3 s2 transpose conv (p1, output_padding 1).
_LAYERS = (("enc1", "s1"), ("enc2", "s2"), ("enc3", "s2"), ("enc4", "s2"),
           ("bottleneck", "s1"), ("dec4", "T"), ("dec3", "T"), ("dec2", "T"),
           ("dec1", "s1"))
_ATTN = (("cross_attention2", "s5"), ("cross_attention1", "s6"))
# Output side of each conv layer, in _LAYERS order.
_OUT_HW = (16, 8, 4, 2, 2, 4, 8, 16, 16)

# Largest batch the kernel takes: one block per element, and the JAX
# package's limit, so both route the same buckets.
FUSED_MAX_BATCH = 8

@dataclasses.dataclass
class FusedOperands:
    """Packed operands of one trajectory (everything but the latents)."""

    conv_w: List[torch.Tensor]        # 9 x [3, 3, Cin, Cout]
    conv_b: List[torch.Tensor]        # 9 x [Cout]
    attn: List[List[torch.Tensor]]    # 2 x [wq, bq, k, v, wo, bo]
    temb: torch.Tensor                # [S-1, 128], working type
    coefs: torch.Tensor               # [S-1, 5], f32
    dtype: torch.dtype
    batch: int


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

    conv_w, conv_b = [], []
    for name, kind in _LAYERS:
        layer = getattr(unet, name)
        # Conv2d [O, I, kh, kw] / ConvTranspose2d [I, O, kh, kw] -> [kh, kw,
        # I, O]: the transpose conv is computed directly in its own
        # geometry, so its kernel is not flipped.
        perm = (2, 3, 0, 1) if kind == "T" else (2, 3, 1, 0)
        conv_w.append(layer.weight.permute(*perm).to(dt).contiguous())
        conv_b.append(layer.bias.to(dt).contiguous())

    attn = []
    for name, skey in _ATTN:
        mod = getattr(unet, name)
        s = style_embedding[skey].to(device=dev, dtype=dt)
        if s.shape[0] == 1 and batch > 1:
            s = s.expand(batch, *s.shape[1:])
        if s.shape[0] != batch:
            raise ValueError(f"style embedding batch {s.shape[0]} != "
                             f"kernel batch {batch}")
        tokens = s.reshape(batch, -1, s.shape[-1])      # NHWC -> [B, Tk, C]
        k = F.linear(tokens, mod.k_proj.weight, mod.k_proj.bias)
        v = F.linear(tokens, mod.v_proj.weight, mod.v_proj.bias)
        attn.append([t.to(dt).contiguous() for t in (
            mod.q_proj.weight.t(), mod.q_proj.bias, k, v,
            mod.out_proj.weight.t(), mod.out_proj.bias)])
    return FusedOperands(conv_w, conv_b, attn, temb,
                         torch.as_tensor(coefs, device=dev), dt, batch)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


def _attention_reference(z, wq, bq, k, v, wo, bo, rnd):
    """z [B, C, H, W] f32 (values of the working type) -> [B, C, H, W]."""
    B, C, H, W = z.shape
    hd = C // _N_HEADS
    q = rnd(z.flatten(2).transpose(1, 2) @ wq.float() + bq.float())
    q = q.reshape(B, H * W, _N_HEADS, hd)
    kh = k.float().reshape(B, -1, _N_HEADS, hd)
    vh = v.float().reshape(B, -1, _N_HEADS, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kh) * (1.0 / math.sqrt(hd))
    p = rnd(torch.softmax(logits, dim=-1))
    att = rnd(torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(B, H * W, C))
    out = att @ wo.float() + bo.float()
    return out.transpose(1, 2).reshape(B, C, H, W)


def _unet_step_reference(x, ops: FusedOperands, i: int):
    """One UNet forward on f32 latents x [B, 32, 16, 16] -> eps f32."""
    def rnd(a):
        return a.to(ops.dtype).float()

    def conv(name, a):
        j = [n for n, _ in _LAYERS].index(name)
        kind = _LAYERS[j][1]
        w, b = ops.conv_w[j].float(), ops.conv_b[j].float()
        if kind == "T":
            return F.conv_transpose2d(a, w.permute(2, 3, 0, 1), b, stride=2,
                                      padding=1, output_padding=1)
        return F.conv2d(a, w.permute(3, 2, 0, 1), b,
                        stride=2 if kind == "s2" else 1, padding=1)

    temb = ops.temb[i].float()[None, :, None, None]
    a2, a1 = ops.attn
    z1 = rnd(torch.relu(conv("enc1", rnd(x))))
    z2 = rnd(torch.relu(conv("enc2", z1)) + temb)
    z3 = rnd(torch.relu(conv("enc3", z2)))
    z3a = rnd(_attention_reference(z3, *a2, rnd))
    z4 = rnd(torch.relu(conv("enc4", z3a)))
    z4a = rnd(_attention_reference(z4, *a1, rnd))
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
    x = z_t.float().permute(0, 3, 1, 2)
    prev = torch.zeros_like(x)
    coefs = ops.coefs.cpu().numpy()
    for i in range(n_steps):
        eps = _unet_step_reference(x, ops, i)
        A, B, C, P, Q = (float(c) for c in coefs[i])
        x, prev = A * x + B * eps + C * prev, P * x + Q * eps
    return x.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------


class _SamplerArgs(ctypes.Structure):
    """Mirror of ``struct SamplerArgs`` in csrc/fused_sampler.cu."""

    _fields_ = [("conv_w", ctypes.c_void_p * 9),
                ("conv_b", ctypes.c_void_p * 9),
                ("attn", (ctypes.c_void_p * 6) * 2),
                ("temb", ctypes.c_void_p),
                ("coefs", ctypes.c_void_p),
                ("x_in", ctypes.c_void_p),
                ("x_out", ctypes.c_void_p),
                ("workspace", ctypes.c_void_p),
                ("n_steps", ctypes.c_int),
                ("batch", ctypes.c_int)]


def build_fused_sampler() -> dict:
    """Compile csrc/fused_sampler.cu (ops/_build.py).  Returns {'path',
    'seconds', 'log'}."""
    return build_library("fused_sampler.cu")


@functools.cache
def _library():
    lib = ctypes.CDLL(build_fused_sampler()["path"])
    lib.fused_sampler_workspace_bytes.argtypes = [ctypes.c_int]
    lib.fused_sampler_workspace_bytes.restype = ctypes.c_size_t
    lib.fused_sampler_args_size.argtypes = []
    lib.fused_sampler_args_size.restype = ctypes.c_size_t
    lib.fused_ddim_sample.argtypes = [ctypes.POINTER(_SamplerArgs),
                                      ctypes.c_int, ctypes.c_void_p]
    lib.fused_ddim_sample.restype = ctypes.c_int
    if lib.fused_sampler_args_size() != ctypes.sizeof(_SamplerArgs):
        raise RuntimeError("SamplerArgs layout differs between the CUDA "
                           "source and its ctypes mirror")
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(ops: FusedOperands, z_t: torch.Tensor, n_steps: int):
    if ops.dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel supports float32 and bfloat16, not "
                         f"{ops.dtype}")
    if n_steps > ops.coefs.shape[0]:
        raise ValueError(f"n_steps={n_steps} > packed steps "
                         f"{ops.coefs.shape[0]}")
    tensors = (ops.conv_w + ops.conv_b + ops.attn[0] + ops.attn[1]
               + [ops.temb])
    for t in tensors:
        if (t.device != z_t.device or t.dtype != ops.dtype
                or not t.is_contiguous()):
            raise ValueError("packed operands must be contiguous "
                             f"{ops.dtype} tensors on {z_t.device}")
    lib = _library()
    B = z_t.shape[0]
    x_in = z_t.float().contiguous()
    out = torch.empty_like(x_in)
    coefs = ops.coefs.to(device=z_t.device, dtype=torch.float32).contiguous()
    ws = torch.empty(B * lib.fused_sampler_workspace_bytes(
        _DTYPE_CODE[ops.dtype]), dtype=torch.uint8, device=z_t.device)
    args = _SamplerArgs()
    for j in range(9):
        args.conv_w[j] = ops.conv_w[j].data_ptr()
        args.conv_b[j] = ops.conv_b[j].data_ptr()
    for a in range(2):
        for j in range(6):
            args.attn[a][j] = ops.attn[a][j].data_ptr()
    args.temb = ops.temb.data_ptr()
    args.coefs = coefs.data_ptr()
    args.x_in = x_in.data_ptr()
    args.x_out = out.data_ptr()
    args.workspace = ws.data_ptr()
    args.n_steps = n_steps
    args.batch = B
    stream = torch.cuda.current_stream(z_t.device).cuda_stream
    err = lib.fused_ddim_sample(ctypes.byref(args), _DTYPE_CODE[ops.dtype],
                                stream)
    if err != 0:
        raise RuntimeError(f"fused sampler kernel launch failed: CUDA "
                           f"error {err}")
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
    for w, hw, (_, kind) in zip(ops.conv_w, _OUT_HW, _LAYERS):
        # A transpose conv's 9 taps act on its input pixels.
        px = (hw // 2) ** 2 if kind == "T" else hw * hw
        macs += 9 * w.shape[2] * w.shape[3] * px
    for a, m in zip(ops.attn, (16, 4)):
        c, tk = a[0].shape[0], a[2].shape[1]
        macs += 2 * m * c * c + 2 * m * tk * c
    tensors = (ops.conv_w + ops.conv_b + ops.attn[0] + ops.attn[1]
               + [ops.temb, ops.coefs])
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
    Returns decoded images in [0, 1], NHWC f32."""
    if content.shape[0] > FUSED_MAX_BATCH:
        raise ValueError(f"fused sampler packs at most B={FUSED_MAX_BATCH}"
                         f"; got batch {content.shape[0]} — use the scan "
                         "samplers (models/ldm.py) for larger batches")
    z_t = ldm.noised_latents(content, num_timesteps, noise, seeds)
    emb = ldm.style_embed(style)
    times = transfer_time_grid(num_timesteps, steps)
    ops = pack_operands(ldm.unet, emb, ldm.schedule, times, eta,
                        sampler=sampler, batch=content.shape[0])
    sampled = fused_ddim_sample(ops, z_t.permute(0, 2, 3, 1), len(times) - 1)
    return ldm.decode_unit(sampled.permute(0, 3, 1, 2))
