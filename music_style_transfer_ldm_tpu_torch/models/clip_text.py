"""CLIP ViT-L/14's text tower, the text encoder of Stable Diffusion 1.5
and Riffusion v1, named as ``transformers``' ``CLIPTextModel`` names it
(so its state dict loads into either).

Token and learned position embeddings (49,408 x 768, 77 x 768), 12
pre-LayerNorm layers of width 768 (12 heads, causal self-attention with
biases; an MLP 768 -> 3,072 -> 768 with quick-GELU, x sigmoid(1.702 x);
LayerNorm eps 1e-5), then a final LayerNorm; the output is the last
hidden states [B, 77, 768].  123,060,480 parameters.

A prompt is BOS (49406), its token ids, then EOS (49407) to 77
positions; the unconditional prompt is BOS then EOS (``prompt_ids``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from music_style_transfer_ldm_tpu_torch.config import TextEncoderConfig


def prompt_ids(ids: Sequence[int],
               config: TextEncoderConfig = TextEncoderConfig()) -> np.ndarray:
    """[max_positions] int64: BOS, ``ids`` (at most max_positions - 2 of
    them), then EOS to the end.  Ids must lie below BOS."""
    ids = [int(i) for i in ids]
    n = config.max_positions
    if len(ids) > n - 2:
        raise ValueError(f"a prompt holds at most {n - 2} token ids, got "
                         f"{len(ids)}")
    if any(not 0 <= i < config.bos_id for i in ids):
        raise ValueError(f"token ids lie in [0, {config.bos_id})")
    out = np.full((n,), config.eos_id, np.int64)
    out[0] = config.bos_id
    out[1:1 + len(ids)] = ids
    return out


class _Embeddings(nn.Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(c.vocab_size, c.width)
        self.position_embedding = nn.Embedding(c.max_positions, c.width)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return (self.token_embedding(ids)
                + self.position_embedding.weight[:ids.shape[1]])


class _SelfAttention(nn.Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.heads = c.heads
        self.q_proj = nn.Linear(c.width, c.width)
        self.k_proj = nn.Linear(c.width, c.width)
        self.v_proj = nn.Linear(c.width, c.width)
        self.out_proj = nn.Linear(c.width, c.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape

        def split(t):
            return t.reshape(B, N, self.heads, C // self.heads).transpose(1, 2)
        out = F.scaled_dot_product_attention(
            split(self.q_proj(x)), split(self.k_proj(x)),
            split(self.v_proj(x)), is_causal=True)
        return self.out_proj(out.transpose(1, 2).reshape(B, N, C))


class _MLP(nn.Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.fc1 = nn.Linear(c.width, c.mlp_dim)
        self.fc2 = nn.Linear(c.mlp_dim, c.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))


class _Layer(nn.Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.self_attn = _SelfAttention(c)
        self.layer_norm1 = nn.LayerNorm(c.width, eps=c.eps)
        self.mlp = _MLP(c)
        self.layer_norm2 = nn.LayerNorm(c.width, eps=c.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(c) for _ in range(c.layers)])


class _TextModel(nn.Module):
    def __init__(self, c: TextEncoderConfig):
        super().__init__()
        self.embeddings = _Embeddings(c)
        self.encoder = _Encoder(c)
        self.final_layer_norm = nn.LayerNorm(c.width, eps=c.eps)


class CLIPTextEncoder(nn.Module):
    """[B, 77] token ids -> the last hidden states [B, 77, width] in the
    model's type."""

    def __init__(self, config: TextEncoderConfig = TextEncoderConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextModel(config)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        x = tm.embeddings(ids.long())
        for layer in tm.encoder.layers:
            x = layer(x)
        return tm.final_layer_norm(x)
