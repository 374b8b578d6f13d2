"""The work of Riffusion v1's served clip, for its cell's utilisation
metrics: the attention cores' operations by shape, and the whole clip
counted by FlopCounterMode over the plain reference."""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench import compare
from portbench.reference import riffusion as ref


def transformer_shapes(model: dict) -> List[Tuple[int, int]]:
    """(tokens, channels) of each Transformer2D of one UNet call, down,
    mid and up paths."""
    u = model["unet"]
    chans, cross = u["block_out_channels"], u["cross_attention"]
    side = model["image_size"] // 8
    out = []
    for i, c in enumerate(chans):
        if cross[i]:
            # the down level's pairs and the mirrored up level's triples
            n = (side >> i) ** 2
            out += [(n, c)] * (2 * u["layers_per_block"] + 1)
    mid = (side >> (len(chans) - 1)) ** 2
    return out + [(mid, chans[-1])]


def attention_flops_per_row(model: dict) -> float:
    """Operations of the attention cores (q k^T and the weights times v,
    2 per multiply-add) of one UNet call on one row: self-attention over
    the level's tokens and cross-attention over the text's positions."""
    m = model["text"]["max_positions"]
    return float(sum(4 * n * n * c + 4 * n * m * c
                     for n, c in transformer_shapes(model)))


def clip_flops(P: dict, model: dict, serve: dict, audio: dict,
               device) -> float:
    """FLOPs of one served clip (matrix products and convolutions of the
    text encoder, the guided walk, the VAE and NNLS; no FFT), counted by
    FlopCounterMode over the reference."""
    size = model["image_size"]
    x = torch.zeros((1, size, size), device=device)
    ids = torch.as_tensor(ref.prompt_ids([1], model["text"])[None],
                          device=device)

    def clip():
        img = ref.transfer(P, x, ids, [0], model, serve)
        ref.image_to_audio(img, audio)
    return compare.step_flops(clip)
