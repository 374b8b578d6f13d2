"""Seeded weights of the LDM and its two feature trunks, by name.

The names and shapes are the reference's own (``nets.py``), written as
the program's state dicts name them, so one dict loads into both sides.
Every tensor comes from one uniform draw on the device per model (a
generator seeded by the run's seed), cut and scaled per tensor:

* conv and linear weights uniform with variance 2 / fan_in (He: the
  signal keeps its scale through the ReLUs, so every layer has a
  gradient worth comparing), biases uniform in +-1 / sqrt(fan_in);
* BatchNorm: scale 1 +- 0.1, shift +- 0.1, running mean +- 0.1, running
  variance in [1, 1.5];
* LPIPS heads uniform in [0, 0.1] (flax's init of the reference).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _conv(spec: Spec, name: str, cin: int, cout: int, k: int,
          transpose: bool = False, bias: bool = True) -> None:
    shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
    fan_in = (cout if transpose else cin) * k * k
    spec.append((f"{name}.weight", shape, f"w{fan_in}"))
    if bias:
        spec.append((f"{name}.bias", (cout,), f"b{fan_in}"))


def _linear(spec: Spec, name: str, cin: int, cout: int) -> None:
    spec.append((f"{name}.weight", (cout, cin), f"w{cin}"))
    spec.append((f"{name}.bias", (cout,), f"b{cin}"))


def _bn(spec: Spec, name: str, c: int) -> None:
    for part, kind in (("weight", "gamma"), ("bias", "beta"),
                       ("running_mean", "mean"), ("running_var", "var"),
                       ("num_batches_tracked", "count")):
        spec.append((f"{name}.{part}", () if kind == "count" else (c,),
                     kind))


def ldm_spec(model: dict) -> Spec:
    lat, nf, sf = (model["latent_dim"], model["unet_num_filters"],
                   model["style_num_filters"])
    temb = model["time_emb_dim"]
    spec: Spec = []
    for i, (ci, co) in enumerate(((1, 64), (64, 128), (128, lat)), 1):
        _conv(spec, f"encoder.conv{i}", ci, co, 3)
        _bn(spec, f"encoder.bn{i}", co)
    _conv(spec, "decoder.deconv1", lat, 128, 4, transpose=True)
    _bn(spec, "decoder.bn1", 128)
    _conv(spec, "decoder.deconv2", 128, 64, 4, transpose=True)
    _bn(spec, "decoder.bn2", 64)
    _conv(spec, "decoder.deconv3", 64, 1, 4, transpose=True)
    _linear(spec, "unet.time_fc1", temb, temb)
    _linear(spec, "unet.time_fc2", temb, temb)
    _conv(spec, "unet.enc1", lat, nf, 3)
    _conv(spec, "unet.enc2", nf, nf * 2, 3)
    _conv(spec, "unet.enc3", nf * 2, nf * 4, 3)
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(spec, f"unet.cross_attention2.{p}", nf * 4, nf * 4)
    _conv(spec, "unet.enc4", nf * 4, nf * 8, 3)
    for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(spec, f"unet.cross_attention1.{p}", nf * 8, nf * 8)
    _conv(spec, "unet.bottleneck", nf * 8, nf * 8, 3)
    _conv(spec, "unet.dec4", nf * 8, nf * 4, 3, transpose=True)
    _conv(spec, "unet.dec3", nf * 4, nf * 2, 3, transpose=True)
    _conv(spec, "unet.dec2", nf * 2, nf, 3, transpose=True)
    _conv(spec, "unet.dec1", nf, lat, 3)
    chans = [(1, sf), (sf, sf * 2), (sf * 2, sf * 4), (sf * 4, sf * 4),
             (sf * 4, sf * 4), (sf * 4, sf * 8)]
    for i, (ci, co) in enumerate(chans, 1):
        _conv(spec, f"style_encoder.enc{i}", ci, co, 3)
    return spec


def vggish_spec() -> Spec:
    spec: Spec = []
    cin = 1
    for name, cout in (("conv1", 64), ("conv2", 128), ("conv3_1", 256),
                       ("conv3_2", 256), ("conv4_1", 512),
                       ("conv4_2", 512)):
        _conv(spec, name, cin, cout, 3)
        cin = cout
    return spec


def lpips_spec() -> Spec:
    spec: Spec = []
    cin = 3
    chans = (("conv1", 64, 11), ("conv2", 192, 5), ("conv3", 384, 3),
             ("conv4", 256, 3), ("conv5", 256, 3))
    for name, cout, k in chans:
        _conv(spec, f"alex.{name}", cin, cout, k)
        cin = cout
    for i, (_, c, _) in enumerate(chans):
        spec.append((f"lin{i}.weight", (1, c, 1, 1), "head"))
    return spec


def _scale(u: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "count":
        return torch.zeros((), dtype=torch.int64, device=u.device)
    if kind == "head":
        return 0.1 * u
    s = 2.0 * u - 1.0
    if kind == "gamma":
        return 1.0 + 0.1 * s
    if kind in ("beta", "mean"):
        return 0.1 * s
    if kind == "var":
        return 1.0 + 0.5 * u
    if kind.startswith("w"):
        return s * math.sqrt(6.0 / int(kind[1:]))
    if kind.startswith("b"):
        return s / math.sqrt(int(kind[1:]))
    raise ValueError(kind)


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors of ``spec`` from one seeded draw on ``device``."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=g, device=device)
    out, pos = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        out[name] = _scale(flat[pos:pos + n].reshape(shape), kind)
        pos += n
    return out


def seeded_weights(model: dict, seed: int, device, trunks: bool = False
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'ldm': ..., and with ``trunks`` 'vggish', 'lpips'}; each model
    from its own seed derived from ``seed``."""
    out = {"ldm": make(ldm_spec(model), seed * 4 + 1, device)}
    if trunks:
        out["vggish"] = make(vggish_spec(), seed * 4 + 2, device)
        out["lpips"] = make(lpips_spec(), seed * 4 + 3, device)
    return out
