"""Carry the reference's own PyTorch weights into the port's modules.

A user of the reference who has trained ``encoder.pth`` / ``decoder.pth``
/ ``ldm_<epoch>.pth`` keeps their weights: each converter maps a
reference state dict (torch tensors or numpy arrays) straight to a state
dict of the port's module, with no flax layout in between.  Both sides
are PyTorch, so most of the map renames keys:

* encoder: the reference's ``encoder`` Sequential, indices 0/1, 3/4, 6/7
  -> ``conv1``/``bn1`` .. ``conv3``/``bn3``;
* decoder: indices 0/1, 3/4, 6 -> ``deconv1``/``bn1``, ``deconv2``/
  ``bn2``, ``deconv3``.  ``ConvTranspose2d`` weights [I, O, kh, kw] are
  copied as they are: the port's transpose convs have PyTorch's own
  geometry (checkpoint format 2), so there is no kernel flip;
* style encoder: ``enc1`` .. ``enc6`` as they are;
* UNet: ``time_mlp.1`` / ``.3`` -> ``time_fc1`` / ``time_fc2``; each
  ``cross_attentionN.multihead_attn``'s packed ``in_proj_weight`` [3E, E]
  and ``in_proj_bias`` [3E] split by rows into the port's
  ``q_proj``/``k_proj``/``v_proj`` Linears (q, k, v in that order, the
  layout ``nn.MultiheadAttention`` packs), ``out_proj`` as it is; convs
  and transpose convs as they are;
* BatchNorm: weight, bias, running_mean and running_var as they are.
  ``num_batches_tracked`` is set to 0: the port's BatchNorm updates with
  flax's fixed momentum and never reads or advances the count.

``convert_ldm_state_dict`` splits a full reference checkpoint by its
``encoder.`` / ``decoder.`` / ``unet.`` / ``style_encoder.`` prefixes;
its ``noise_scheduler.`` buffers are dropped (the port recomputes the
schedule from its config).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(x, np.float32))


def _strip(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _copy(out: Dict, dst: str, sd: Dict, src: str,
          keys=("weight", "bias")) -> None:
    for k in keys:
        out[f"{dst}.{k}"] = _t(sd[f"{src}.{k}"])


def _bn(out: Dict, dst: str, sd: Dict, src: str) -> None:
    _copy(out, dst, sd, src, _BN_KEYS)
    out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def convert_encoder_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference's ``encoder.pth`` (keys ``encoder.<i>.*``, or bare
    ``<i>.*``) -> a state dict of ``SpectrogramEncoder``."""
    if any(k.startswith("encoder.") for k in sd):
        sd = _strip(sd, "encoder.")
    out: Dict[str, torch.Tensor] = {}
    for i, (conv, bn) in enumerate(((0, 1), (3, 4), (6, 7)), 1):
        _copy(out, f"conv{i}", sd, str(conv))
        _bn(out, f"bn{i}", sd, str(bn))
    return out


def convert_decoder_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference's ``decoder.pth`` (keys ``decoder.<i>.*``, or bare
    ``<i>.*``) -> a state dict of ``SpectrogramDecoder``."""
    if any(k.startswith("decoder.") for k in sd):
        sd = _strip(sd, "decoder.")
    out: Dict[str, torch.Tensor] = {}
    for i, convt in enumerate((0, 3, 6), 1):
        _copy(out, f"deconv{i}", sd, str(convt))
    for i, bn in enumerate((1, 4), 1):
        _bn(out, f"bn{i}", sd, str(bn))
    return out


def convert_style_encoder_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference's StyleEncoder (``enc1`` .. ``enc6``) -> a state dict
    of ``StyleEncoder``."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(1, 7):
        _copy(out, f"enc{i}", sd, f"enc{i}")
    return out


def _attention(out: Dict, dst: str, sd: Dict, src: str) -> None:
    w = _t(sd[f"{src}.in_proj_weight"])     # [3E, E], rows q | k | v
    b = _t(sd[f"{src}.in_proj_bias"])
    e = w.shape[1]
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[f"{dst}.{name}.weight"] = w[i * e:(i + 1) * e].clone()
        out[f"{dst}.{name}.bias"] = b[i * e:(i + 1) * e].clone()
    _copy(out, f"{dst}.out_proj", sd, f"{src}.out_proj")


def convert_unet_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """The reference's UNet -> a state dict of ``UNet``."""
    out: Dict[str, torch.Tensor] = {}
    _copy(out, "time_fc1", sd, "time_mlp.1")
    _copy(out, "time_fc2", sd, "time_mlp.3")
    for name in ("enc1", "enc2", "enc3", "enc4", "bottleneck", "dec4",
                 "dec3", "dec2", "dec1"):
        _copy(out, name, sd, name)
    for name in ("cross_attention1", "cross_attention2"):
        _attention(out, name, sd, f"{name}.multihead_attn")
    return out


def convert_ldm_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """A full reference checkpoint (``ldm_<epoch>.pth``) -> a state dict of
    the port's ``LDM``."""
    out: Dict[str, torch.Tensor] = {}
    for comp, fn in (("encoder", convert_encoder_state_dict),
                     ("decoder", convert_decoder_state_dict),
                     ("unet", convert_unet_state_dict),
                     ("style_encoder", convert_style_encoder_state_dict)):
        for k, v in fn(_strip(sd, f"{comp}.")).items():
            out[f"{comp}.{k}"] = v
    return out


def convert_autoencoder_state_dicts(encoder_sd: Dict, decoder_sd: Dict
                                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``encoder.pth`` + ``decoder.pth`` -> {"encoder": state_dict,
    "decoder": state_dict}, the ``params`` of an autoencoder checkpoint
    (``training/checkpoint.py save_autoencoder``)."""
    return {"encoder": convert_encoder_state_dict(encoder_sd),
            "decoder": convert_decoder_state_dict(decoder_sd)}
