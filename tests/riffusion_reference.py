"""The plain reference of Riffusion v1's SDEdit serving path, in float32
with TF32 off: the CLIP text encoder, the UNet, the KL VAE, the guided
DDIM walk and the audio inversion at Riffusion's geometry.

Plain ``torch`` over flat dicts of tensors named as diffusers and
``transformers`` name them (so one dict of weights loads into the
measured program and into this); it imports neither JAX nor any module
of the program.  ``portbench/reference/riffusion.py`` is the benchmark's
copy of this file.

* text: token + position embeddings, pre-LayerNorm layers (causal
  self-attention, quick-GELU MLP), a final LayerNorm;
* UNet: ResNets (GroupNorm, SiLU, 3x3 convs, the time embedding after
  the first conv), Transformer2D blocks (self-attention, cross-attention
  to the text, GEGLU), the skip concatenations of four levels;
* VAE: the encoder's latent mean times the scaling factor, the decoder
  on the latent over it; one-head attention in each mid block;
* attention in blocks of queries, so a 4,096-token head fits;
* SDEdit: ``scaled_linear`` betas; the content's latent noised to t =
  N - 1 with the request's draw (a generator seeded by the request's
  seed, [S/8, S/8, 4] drawn NHWC), then DDIM (eta 0) over linspace(N - 1,
  0, steps) floored, eps = eps_u + g (eps_c - eps_u) with eps_u the
  empty prompt's; the output image is the mean of the decoded RGB in
  [0, 1];
* audio: Riffusion's image law read back at ``max_value``, an HTK mel
  filterbank without normalisation, non-negative least squares (64
  FISTA steps from the clipped pseudo-inverse solution), then fast
  Griffin-Lim (momentum 0.99, one seeded field of start phases) with a
  ``win_length`` periodic Hann window centred in ``n_fft``.

``Precision("fp8")`` rounds every operand of a product (convolutions,
linear layers, attention) to float8 e4m3 under a per-tensor scale: the
control, one precision below the bf16 the model is served in; the
audio's control runs its least-squares products in TF32.
``seeded_weights`` makes every tensor from one seeded uniform draw.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- precision

class Precision:
    """How a product reads its operands: as they are (float32), or
    rounded to float8 e4m3 under a per-tensor scale (fp8)."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return x
        scale = 448.0 / x.abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).float() / scale


F32 = Precision()


@contextlib.contextmanager
def exact_f32(matmul_tf32: bool = False):
    """TF32 off for cuDNN's convolutions; cuBLAS's as asked."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- layers

def conv(P: Params, name: str, x, prec: Precision = F32, stride: int = 1,
         padding=None):
    w = P[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(prec.q(x), prec.q(w), P[f"{name}.bias"], stride, pad)


def linear(P: Params, name: str, x, prec: Precision = F32):
    return F.linear(prec.q(x), prec.q(P[f"{name}.weight"]),
                    P.get(f"{name}.bias"))


def group_norm(P: Params, name: str, x, groups: int, eps: float):
    return F.group_norm(x, groups, P[f"{name}.weight"], P[f"{name}.bias"],
                        eps)


def layer_norm(P: Params, name: str, x, eps: float = 1e-5):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                        P[f"{name}.bias"], eps)


def attention(q, k, v, heads: int, prec: Precision = F32,
              causal: bool = False, block: int = 1024):
    """q [B, N, C], k and v [B, M, C] -> [B, N, C]; softmax(q k^T /
    sqrt(d)) v per head, ``block`` queries at a time."""
    B, N, C = q.shape
    M, d = k.shape[1], C // heads
    q = q.reshape(B, N, heads, d).transpose(1, 2)
    k = prec.q(k.reshape(B, M, heads, d).transpose(1, 2))
    v = prec.q(v.reshape(B, M, heads, d).transpose(1, 2))
    out = torch.empty_like(q)
    for s in range(0, N, block):
        logits = torch.matmul(prec.q(q[:, :, s:s + block]),
                              k.transpose(-1, -2)) / math.sqrt(d)
        if causal:
            i = torch.arange(s, s + logits.shape[-2], device=q.device)
            j = torch.arange(M, device=q.device)
            logits = logits.masked_fill(j[None, :] > i[:, None],
                                        float("-inf"))
        out[:, :, s:s + block] = torch.matmul(
            prec.q(torch.softmax(logits, -1)), v)
    return out.transpose(1, 2).reshape(B, N, C)


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


def _image(t, like):
    return t.transpose(1, 2).reshape(like.shape)


# ---------------------------------------------------------------- text

def text_encoder(P: Params, ids: torch.Tensor, c: dict,
                 prec: Precision = F32) -> torch.Tensor:
    """[B, 77] token ids -> the last hidden states [B, 77, width]."""
    p = "text_model."
    x = (P[p + "embeddings.token_embedding.weight"][ids.long()]
         + P[p + "embeddings.position_embedding.weight"][:ids.shape[1]])
    for i in range(c["layers"]):
        n = f"{p}encoder.layers.{i}."
        h = layer_norm(P, n + "layer_norm1", x, c["eps"])
        a = n + "self_attn."
        h = attention(linear(P, a + "q_proj", h, prec),
                      linear(P, a + "k_proj", h, prec),
                      linear(P, a + "v_proj", h, prec), c["heads"], prec,
                      causal=True)
        x = x + linear(P, a + "out_proj", h, prec)
        h = linear(P, n + "mlp.fc1", layer_norm(P, n + "layer_norm2", x,
                                               c["eps"]), prec)
        x = x + linear(P, n + "mlp.fc2", h * torch.sigmoid(1.702 * h), prec)
    return layer_norm(P, p + "final_layer_norm", x, c["eps"])


# ---------------------------------------------------------------- UNet

def resnet(P: Params, name: str, x, temb, groups: int, eps: float,
           prec: Precision = F32):
    h = conv(P, f"{name}.conv1", F.silu(group_norm(P, f"{name}.norm1", x,
                                                   groups, eps)), prec)
    if temb is not None:
        h = h + linear(P, f"{name}.time_emb_proj", F.silu(temb),
                       prec)[:, :, None, None]
    h = conv(P, f"{name}.conv2", F.silu(group_norm(P, f"{name}.norm2", h,
                                                   groups, eps)), prec)
    if f"{name}.conv_shortcut.weight" in P:
        x = conv(P, f"{name}.conv_shortcut", x, prec)
    return x + h


def _attn(P: Params, name: str, x, ctx, heads: int, prec: Precision):
    ctx = x if ctx is None else ctx
    out = attention(linear(P, f"{name}.to_q", x, prec),
                    linear(P, f"{name}.to_k", ctx, prec),
                    linear(P, f"{name}.to_v", ctx, prec), heads, prec)
    return linear(P, f"{name}.to_out.0", out, prec)


def transformer(P: Params, name: str, x, ctx, c: dict,
                prec: Precision = F32):
    h = conv(P, f"{name}.proj_in", group_norm(
        P, f"{name}.norm", x, c["groups"], c["transformer_eps"]), prec)
    t = _tokens(h)
    b = f"{name}.transformer_blocks.0"
    t = t + _attn(P, f"{b}.attn1", layer_norm(P, f"{b}.norm1", t), None,
                  c["heads"], prec)
    t = t + _attn(P, f"{b}.attn2", layer_norm(P, f"{b}.norm2", t), ctx,
                  c["heads"], prec)
    a, gate = linear(P, f"{b}.ff.net.0.proj", layer_norm(P, f"{b}.norm3", t),
                     prec).chunk(2, -1)
    t = t + linear(P, f"{b}.ff.net.2", a * F.gelu(gate), prec)
    return conv(P, f"{name}.proj_out", _image(t, h), prec) + x


def sinusoids(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' Timesteps(dim, flip_sin_to_cos=True, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def unet(P: Params, x, t, ctx, c: dict, prec: Precision = F32):
    """eps of latents x [B, 4, h, w] at timesteps t [B] under text states
    ctx [B, 77, width]."""
    g, eps = c["groups"], c["eps"]
    temb = linear(P, "time_embedding.linear_2", F.silu(linear(
        P, "time_embedding.linear_1", sinusoids(t, c["time_proj_dim"]),
        prec)), prec)
    chans, cross = c["block_out_channels"], c["cross_attention"]
    n, L = len(chans), c["layers_per_block"]
    h = conv(P, "conv_in", x, prec)
    skips = [h]
    for i in range(n):
        for j in range(L):
            h = resnet(P, f"down_blocks.{i}.resnets.{j}", h, temb, g, eps,
                       prec)
            if cross[i]:
                h = transformer(P, f"down_blocks.{i}.attentions.{j}", h, ctx,
                                c, prec)
            skips.append(h)
        if i < n - 1:
            h = conv(P, f"down_blocks.{i}.downsamplers.0.conv", h, prec, 2)
            skips.append(h)
    h = resnet(P, "mid_block.resnets.0", h, temb, g, eps, prec)
    h = transformer(P, "mid_block.attentions.0", h, ctx, c, prec)
    h = resnet(P, "mid_block.resnets.1", h, temb, g, eps, prec)
    for i in range(n):
        for j in range(L + 1):
            h = resnet(P, f"up_blocks.{i}.resnets.{j}",
                       torch.cat([h, skips.pop()], 1), temb, g, eps, prec)
            if cross[n - 1 - i]:
                h = transformer(P, f"up_blocks.{i}.attentions.{j}", h, ctx,
                                c, prec)
        if i < n - 1:
            h = conv(P, f"up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"),
                     prec)
    return conv(P, "conv_out", F.silu(group_norm(P, "conv_norm_out", h, g,
                                                 eps)), prec)


# ---------------------------------------------------------------- VAE

def _vae_mid(P: Params, name: str, x, c: dict, prec: Precision):
    g, eps = c["groups"], c["eps"]
    x = resnet(P, f"{name}.resnets.0", x, None, g, eps, prec)
    a = f"{name}.attentions.0"
    h = group_norm(P, f"{a}.group_norm", x, g, eps)
    x = _image(_attn(P, a, _tokens(h), None, 1, prec), h) + x
    return resnet(P, f"{name}.resnets.1", x, None, g, eps, prec)


def vae_encode_mean(P: Params, x, c: dict, prec: Precision = F32):
    """[B, 3, H, W] in [-1, 1] -> the latent mean times the scaling
    factor."""
    g, eps = c["groups"], c["eps"]
    chans, L = c["block_out_channels"], c["layers_per_block"]
    h = conv(P, "encoder.conv_in", x, prec)
    for i in range(len(chans)):
        for j in range(L):
            h = resnet(P, f"encoder.down_blocks.{i}.resnets.{j}", h, None,
                       g, eps, prec)
        if i < len(chans) - 1:
            h = conv(P, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), prec, 2, 0)
    h = _vae_mid(P, "encoder.mid_block", h, c, prec)
    h = conv(P, "encoder.conv_out", F.silu(group_norm(
        P, "encoder.conv_norm_out", h, g, eps)), prec)
    moments = conv(P, "quant_conv", h, prec)
    return moments[:, :c["latent_channels"]] * c["scaling_factor"]


def vae_decode(P: Params, z, c: dict, prec: Precision = F32):
    """Scaled latents -> [B, 3, H, W], about [-1, 1]."""
    g, eps = c["groups"], c["eps"]
    chans, L = c["block_out_channels"], c["layers_per_block"]
    h = conv(P, "post_quant_conv", z / c["scaling_factor"], prec)
    h = _vae_mid(P, "decoder.mid_block", conv(P, "decoder.conv_in", h, prec),
                 c, prec)
    for i in range(len(chans)):
        for j in range(L + 1):
            h = resnet(P, f"decoder.up_blocks.{i}.resnets.{j}", h, None, g,
                       eps, prec)
        if i < len(chans) - 1:
            h = conv(P, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"),
                     prec)
    return conv(P, "decoder.conv_out", F.silu(group_norm(
        P, "decoder.conv_norm_out", h, g, eps)), prec)


# ---------------------------------------------------------------- SDEdit

def alpha_bars(model: dict) -> np.ndarray:
    betas = (np.linspace(model["beta_start"] ** 0.5, model["beta_end"] ** 0.5,
                         model["num_timesteps"], dtype=np.float64) ** 2
             ).astype(np.float32)
    return np.cumprod(np.float32(1.0) - betas, dtype=np.float32)


def prompt_ids(ids: Sequence[int], text: dict) -> np.ndarray:
    """[77] int64: BOS, the ids, EOS to the end."""
    out = np.full((text["max_positions"],), text["eos_id"], np.int64)
    out[0] = text["bos_id"]
    out[1:1 + len(ids)] = ids
    return out


def request_noise(seeds: Sequence[int], channels: int, size: int,
                  device) -> torch.Tensor:
    """[B, channels, size, size]: request i's draw from a generator seeded
    with seeds[i], drawn NHWC."""
    out = []
    for s in seeds:
        g = torch.Generator(device=device)
        g.manual_seed(int(s))
        out.append(torch.randn((size, size, channels), generator=g,
                               device=device))
    return torch.stack(out).permute(0, 3, 1, 2)


def guided_eps(P: Params, x, t: int, text, uncond, model: dict,
               guidance: float, prec: Precision = F32):
    """eps_u + g (eps_c - eps_u) at latents x and timestep t."""
    tt = torch.full((x.shape[0],), int(t), device=x.device)
    e_c = unet(P["unet"], x, tt, text, model["unet"], prec)
    if guidance == 1.0:
        return e_c
    e_u = unet(P["unet"], x, tt, uncond.expand_as(text), model["unet"], prec)
    return e_u + guidance * (e_c - e_u)


def transfer(P: Dict[str, Params], content: torch.Tensor, ids: torch.Tensor,
             seeds: Sequence[int], model: dict, serve: dict,
             prec: Precision = F32) -> torch.Tensor:
    """content [B, S, S] unit grey images, ids [B, 77] -> [B, S, S] unit
    grey images.  ``P``: {'text_encoder', 'unet', 'vae'} weight dicts;
    ``serve``: num_timesteps, sample_steps, guidance."""
    ab = alpha_bars(model)
    f = np.float32
    n, g = serve["num_timesteps"], serve["guidance"]
    with torch.no_grad(), exact_f32():
        x = 2.0 * content.float()[:, None].expand(-1, 3, -1, -1) - 1.0
        z0 = vae_encode_mean(P["vae"], x, model["vae"], prec)
        eps = request_noise(seeds, z0.shape[1], z0.shape[-1], z0.device)
        t0 = n - 1
        x = float(np.sqrt(ab[t0])) * z0 + float(np.sqrt(f(1.0) - ab[t0])) * eps
        text = text_encoder(P["text_encoder"], ids, model["text"], prec)
        uncond = text_encoder(P["text_encoder"], torch.as_tensor(
            prompt_ids([], model["text"])[None], device=ids.device),
            model["text"], prec)
        times = np.linspace(n - 1, 0, serve["sample_steps"]).astype(np.int32)
        for t, tn in zip(times[:-1], times[1:]):
            e = guided_eps(P, x, int(t), text, uncond, model, g, prec)
            x0 = (x - float(np.sqrt(f(1.0) - ab[t])) * e) * float(
                f(1.0) / np.sqrt(ab[t]))
            x = float(np.sqrt(ab[tn])) * x0 + float(
                np.sqrt(f(1.0) - ab[tn])) * e
        rgb = vae_decode(P["vae"], x, model["vae"], prec)
        return ((rgb + 1.0) / 2.0).clamp(0.0, 1.0).mean(1)


# ---------------------------------------------------------------- audio

def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def htk_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """[n_mels, 1 + n_fft // 2] triangles on the HTK scale, peaks 1."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    return np.maximum(0.0, np.minimum(lower, upper)).astype(np.float32)


def image_to_mel(images: torch.Tensor, audio: dict) -> torch.Tensor:
    """[B, n_mels, frames] unit images (highest mel first) -> magnitude
    mel, lowest first."""
    v = 1.0 - images.float().flip(-2)
    return v.clamp(min=0.0) ** (1.0 / audio["image_power"]) * \
        audio["max_value"]


def nnls(B: np.ndarray, M: torch.Tensor, n_iter: int) -> torch.Tensor:
    L = float(np.linalg.norm(B, 2) ** 2)
    pinv = torch.as_tensor(np.linalg.pinv(B).astype(np.float32),
                           device=M.device)
    Bt = torch.as_tensor(B, device=M.device)
    x = torch.clamp(torch.matmul(pinv, M), min=0.0)
    y = x
    inv_l = float(np.float32(1.0 / L))
    t = np.float32(1.0)
    for _ in range(n_iter):
        grad = torch.matmul(Bt.T, torch.matmul(Bt, y) - M)
        x_new = torch.clamp(y - inv_l * grad, min=0.0)
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        y = x_new + float((t - np.float32(1.0)) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x


def _window(win: int, n_fft: int, device) -> torch.Tensor:
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win) / win)
    lpad = (n_fft - win) // 2
    return torch.as_tensor(np.pad(w, (lpad, n_fft - win - lpad)),
                           dtype=torch.float32, device=device)


def stft(y, n_fft: int, hop: int, win: int):
    lead = y.shape[:-1]
    spec = torch.stft(y.reshape(-1, y.shape[-1]), n_fft=n_fft,
                      hop_length=hop, win_length=n_fft,
                      window=_window(win, n_fft, y.device), center=True,
                      pad_mode="constant", onesided=True, return_complex=True)
    return spec.reshape(*lead, *spec.shape[-2:])


def istft(spec, n_fft: int, hop: int, win: int, length=None):
    nf = spec.shape[-1]
    w = _window(win, n_fft, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * w
    out_len = n_fft + hop * (nf - 1)
    lead = frames.shape[:-2]
    y = F.fold(frames.reshape(-1, nf, n_fft).transpose(1, 2),
               output_size=(1, out_len), kernel_size=(1, n_fft),
               stride=(1, hop)).reshape(*lead, out_len)
    w2 = w.double().cpu().numpy() ** 2
    wsum = np.zeros(out_len)
    for i in range(nf):
        wsum[i * hop:i * hop + n_fft] += w2
    wsum = np.where(wsum > 1e-11, wsum, 1.0)
    y = y / torch.as_tensor(wsum, dtype=torch.float32, device=y.device)
    y = y[..., n_fft // 2:out_len - n_fft // 2]
    if length is not None:
        y = y[..., :length] if y.shape[-1] >= length else F.pad(
            y, (0, length - y.shape[-1]))
    return y


def griffin_lim(S, n_iter: int, n_fft: int, hop: int, win: int,
                length: int, seed: int = 0, momentum: float = 0.99):
    g = torch.Generator(device=S.device)
    g.manual_seed(int(seed))
    phase = torch.rand(S.shape[-2:], generator=g, device=S.device) * (
        2.0 * math.pi)
    angles = torch.polar(torch.ones_like(phase), phase).expand(S.shape)
    mscale = momentum / (1.0 + momentum)
    prev = torch.zeros(S.shape, dtype=torch.complex64, device=S.device)
    for _ in range(n_iter):
        rebuilt = stft(istft(S * angles, n_fft, hop, win), n_fft, hop, win)
        z = rebuilt - mscale * prev
        angles = z / (z.abs() + 1e-16)
        prev = rebuilt
    return istft(S * angles, n_fft, hop, win, length)


def image_to_audio(images: torch.Tensor, audio: dict,
                   matmul_tf32: bool = False) -> torch.Tensor:
    """[B, n_mels, frames] unit images -> [B, clip_seconds * sr] audio."""
    sr, n_fft = audio["sample_rate"], audio["n_fft"]
    hop, win = audio["hop_length"], audio["win_length"]
    fb = htk_filterbank(sr, n_fft, images.shape[-2], audio["fmin"],
                        audio["fmax"])
    with torch.no_grad(), exact_f32(matmul_tf32):
        S = nnls(fb, image_to_mel(images, audio), audio["nnls_iters"])
    with torch.no_grad(), exact_f32():
        return griffin_lim(S, audio["griffin_lim_iters"], n_fft, hop, win,
                           int(round(audio["clip_seconds"] * sr)))


# ---------------------------------------------------------------- weights

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int,
          gain: float = 1.0) -> None:
    spec.append((f"{name}.weight", (cout, cin, k, k),
                 f"w{cin * k * k}:{gain}"))
    spec.append((f"{name}.bias", (cout,), f"b{cin * k * k}"))


def _linear(spec: Spec, name: str, cin: int, cout: int, bias: bool = True,
            gain: float = 1.0) -> None:
    spec.append((f"{name}.weight", (cout, cin), f"w{cin}:{gain}"))
    if bias:
        spec.append((f"{name}.bias", (cout,), f"b{cin}"))


def _norm(spec: Spec, name: str, c: int) -> None:
    spec.append((f"{name}.weight", (c,), "gamma"))
    spec.append((f"{name}.bias", (c,), "beta"))


def _resnet(spec: Spec, name: str, cin: int, cout: int, temb) -> None:
    _norm(spec, f"{name}.norm1", cin)
    _conv(spec, f"{name}.conv1", cin, cout, 3)
    if temb:
        _linear(spec, f"{name}.time_emb_proj", temb, cout)
    _norm(spec, f"{name}.norm2", cout)
    _conv(spec, f"{name}.conv2", cout, cout, 3)
    if cin != cout:
        _conv(spec, f"{name}.conv_shortcut", cin, cout, 1)


# Scales of the seeded weights (see ``seeded_weights``).
CROSS_OUT_GAIN = 0.1     # cross-attention outputs: eps_c - eps_u small
EPS_GAIN = 0.7           # the UNet's conv_out: eps about unit scale
LATENT_GAIN = 5.0        # the VAE encoder's conv_out: latents O(1)
IMAGE_GAIN = 0.5         # the VAE decoder's conv_out: few clipped pixels


def _attn_spec(spec: Spec, name: str, dim: int, ctx: int, bias: bool,
               out_gain: float = 1.0) -> None:
    _linear(spec, f"{name}.to_q", dim, dim, bias, 0.5)
    _linear(spec, f"{name}.to_k", ctx, dim, bias, 0.5)
    _linear(spec, f"{name}.to_v", ctx, dim, bias, 0.5)
    _linear(spec, f"{name}.to_out.0", dim, dim, True, out_gain)


def _transformer(spec: Spec, name: str, dim: int, ctx: int) -> None:
    _norm(spec, f"{name}.norm", dim)
    _conv(spec, f"{name}.proj_in", dim, dim, 1)
    b = f"{name}.transformer_blocks.0"
    _norm(spec, f"{b}.norm1", dim)
    _attn_spec(spec, f"{b}.attn1", dim, dim, False)
    _norm(spec, f"{b}.norm2", dim)
    _attn_spec(spec, f"{b}.attn2", dim, ctx, False, CROSS_OUT_GAIN)
    _norm(spec, f"{b}.norm3", dim)
    _linear(spec, f"{b}.ff.net.0.proj", dim, 8 * dim)
    _linear(spec, f"{b}.ff.net.2", 4 * dim, dim)
    _conv(spec, f"{name}.proj_out", dim, dim, 1)


def text_spec(c: dict) -> Spec:
    p = "text_model."
    w = c["width"]
    spec: Spec = [(p + "embeddings.token_embedding.weight",
                   (c["vocab_size"], w), "emb0.02"),
                  (p + "embeddings.position_embedding.weight",
                   (c["max_positions"], w), "emb0.01")]
    for i in range(c["layers"]):
        n = f"{p}encoder.layers.{i}."
        for k in ("q_proj", "k_proj", "v_proj"):
            _linear(spec, n + "self_attn." + k, w, w, gain=0.5)
        _linear(spec, n + "self_attn.out_proj", w, w)
        _norm(spec, n + "layer_norm1", w)
        _linear(spec, n + "mlp.fc1", w, c["mlp_dim"])
        _linear(spec, n + "mlp.fc2", c["mlp_dim"], w)
        _norm(spec, n + "layer_norm2", w)
    _norm(spec, p + "final_layer_norm", w)
    return spec


def unet_spec(c: dict) -> Spec:
    chans, cross = c["block_out_channels"], c["cross_attention"]
    n, L = len(chans), c["layers_per_block"]
    temb, ctx = c["time_embed_dim"], c["cross_attention_dim"]
    spec: Spec = []
    _conv(spec, "conv_in", c["in_channels"], chans[0], 3)
    _linear(spec, "time_embedding.linear_1", c["time_proj_dim"], temb)
    _linear(spec, "time_embedding.linear_2", temb, temb)
    cout = chans[0]
    for i in range(n):
        cin, cout = cout, chans[i]
        for j in range(L):
            _resnet(spec, f"down_blocks.{i}.resnets.{j}",
                    cin if j == 0 else cout, cout, temb)
            if cross[i]:
                _transformer(spec, f"down_blocks.{i}.attentions.{j}", cout,
                             ctx)
        if i < n - 1:
            _conv(spec, f"down_blocks.{i}.downsamplers.0.conv", cout, cout, 3)
    for j in range(2):
        _resnet(spec, f"mid_block.resnets.{j}", chans[-1], chans[-1], temb)
    _transformer(spec, "mid_block.attentions.0", chans[-1], ctx)
    rev = chans[::-1]
    out = rev[0]
    for i in range(n):
        prev, out = out, rev[i]
        skip_in = rev[min(i + 1, n - 1)]
        for j in range(L + 1):
            _resnet(spec, f"up_blocks.{i}.resnets.{j}",
                    (prev if j == 0 else out) + (skip_in if j == L else out),
                    out, temb)
            if cross[n - 1 - i]:
                _transformer(spec, f"up_blocks.{i}.attentions.{j}", out, ctx)
        if i < n - 1:
            _conv(spec, f"up_blocks.{i}.upsamplers.0.conv", out, out, 3)
    _norm(spec, "conv_norm_out", chans[0])
    _conv(spec, "conv_out", chans[0], c["out_channels"], 3, EPS_GAIN)
    return spec


def _vae_mid_spec(spec: Spec, name: str, dim: int) -> None:
    _resnet(spec, f"{name}.resnets.0", dim, dim, None)
    a = f"{name}.attentions.0"
    _norm(spec, f"{a}.group_norm", dim)
    _attn_spec(spec, a, dim, dim, True)
    _resnet(spec, f"{name}.resnets.1", dim, dim, None)


def vae_spec(c: dict) -> Spec:
    chans, L = c["block_out_channels"], c["layers_per_block"]
    lat = c["latent_channels"]
    spec: Spec = []
    _conv(spec, "encoder.conv_in", c["in_channels"], chans[0], 3)
    cout = chans[0]
    for i, ch in enumerate(chans):
        cin, cout = cout, ch
        for j in range(L):
            _resnet(spec, f"encoder.down_blocks.{i}.resnets.{j}",
                    cin if j == 0 else cout, cout, None)
        if i < len(chans) - 1:
            _conv(spec, f"encoder.down_blocks.{i}.downsamplers.0.conv", cout,
                  cout, 3)
    _vae_mid_spec(spec, "encoder.mid_block", chans[-1])
    _norm(spec, "encoder.conv_norm_out", chans[-1])
    _conv(spec, "encoder.conv_out", chans[-1], 2 * lat, 3, LATENT_GAIN)
    _conv(spec, "quant_conv", 2 * lat, 2 * lat, 1)
    _conv(spec, "post_quant_conv", lat, lat, 1)
    rev = chans[::-1]
    _conv(spec, "decoder.conv_in", lat, rev[0], 3)
    _vae_mid_spec(spec, "decoder.mid_block", rev[0])
    out = rev[0]
    for i, ch in enumerate(rev):
        prev, out = out, ch
        for j in range(L + 1):
            _resnet(spec, f"decoder.up_blocks.{i}.resnets.{j}",
                    prev if j == 0 else out, out, None)
        if i < len(rev) - 1:
            _conv(spec, f"decoder.up_blocks.{i}.upsamplers.0.conv", out, out,
                  3)
    _norm(spec, "decoder.conv_norm_out", rev[-1])
    _conv(spec, "decoder.conv_out", rev[-1], c["out_channels"], 3, IMAGE_GAIN)
    return spec


def _scale(u: torch.Tensor, kind: str) -> torch.Tensor:
    s = 2.0 * u - 1.0
    if kind == "gamma":
        return 1.0 + 0.1 * s
    if kind == "beta":
        return 0.1 * s
    if kind.startswith("emb"):
        return s * (math.sqrt(3.0) * float(kind[3:]))
    if kind.startswith("w"):
        fan_in, gain = kind[1:].split(":")
        return s * (float(gain) * math.sqrt(6.0 / int(fan_in)))
    if kind.startswith("b"):
        return s / math.sqrt(int(kind[1:]))
    raise ValueError(kind)


def make(spec: Spec, seed: int, device) -> Params:
    """float32 tensors of ``spec``, drawn one after another from one
    seeded uniform generator on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out = {}
    for name, shape, kind in spec:
        n = math.prod(shape)
        u = torch.rand(n, generator=g, device=device)
        out[name] = _scale(u.reshape(shape), kind)
    return out


def seeded_weights(model: dict, seed: int, device) -> Dict[str, Params]:
    """{'text_encoder', 'unet', 'vae'}: each tensor uniform, from a
    generator per model seeded from ``seed``.  Convolutions and linear
    layers take variance 2 gain^2 / fan_in (He), biases +-1 / sqrt(fan_in),
    norms 1 +- 0.1 and +-0.1, embeddings a std of 0.02 (tokens) and 0.01
    (positions).  q/k/v take gain 0.5; the cross-attention outputs
    ``CROSS_OUT_GAIN``, so the conditional and unconditional branches
    differ by a small part of eps; the UNet's ``conv_out``
    ``EPS_GAIN``, the VAE's ``LATENT_GAIN`` and ``IMAGE_GAIN``: the
    guided latent stays O(1) over the walk and few decoded pixels clip.
    No tensor is zero."""
    return {"text_encoder": make(text_spec(model["text"]), seed * 4 + 1,
                                 device),
            "unet": make(unet_spec(model["unet"]), seed * 4 + 2, device),
            "vae": make(vae_spec(model["vae"]), seed * 4 + 3, device)}
