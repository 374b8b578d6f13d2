"""The plain reference of the autoencoder's training step (phase 1), in
float32 with TF32 off (or, as the control, on), and of AdamW.

One step on a batch of unit images x [B, S, S]:

* the encoder and the decoder (``nets.py``'s geometry) in train mode:
  every BatchNorm on the batch's mean and biased variance, E[x^2] -
  E[x]^2 clipped at 0, its running statistics updated with momentum 0.9
  (flax's semantics, as ``models/layers.py BatchNorm`` of the program
  documents them);
* recon = (decoder(encoder(x)) + 1) / 2;
* loss = MSE(recon, x) + 0.1 LPIPS(x, recon) + 0.01 KL(z), with
  ``train.py``'s ``mse``, ``lpips`` and ``kl``;
* AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 0.01 applied as
  p <- p (1 - lr wd) before the bias-corrected Adam update) on every
  parameter of the two.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import nets
from portbench.reference.train import Adam, kl, lpips, mse


def encoder_train(P: Dict[str, torch.Tensor], x: torch.Tensor,
                  new_stats: dict, prec: nets.Precision = nets.F32
                  ) -> torch.Tensor:
    """[B, 1, S, S] -> the latent, every BatchNorm on the batch."""
    for i in (1, 2, 3):
        x = nets.batch_norm(P, f"encoder.bn{i}",
                            nets.conv(P, f"encoder.conv{i}", x, 2, 1, prec),
                            True, new_stats)
        if i < 3:
            x = torch.relu(x)
    return x


def ae_loss(P: Dict[str, torch.Tensor], lpips_P: dict, x: torch.Tensor,
            train: dict, new_stats: dict,
            prec: nets.Precision = nets.F32) -> torch.Tensor:
    z = encoder_train(P, x[:, None], new_stats, prec)
    recon = (nets.decoder(P, z, True, new_stats, prec)[:, 0] + 1.0) / 2.0
    return (mse(recon, x)
            + train["perceptual_weight"] * lpips(lpips_P, x, recon, prec)
            + train["kl_weight"] * kl(z))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as a tensor core reads a float32 operand."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


class TF32Precision(nets.Precision):
    """The control's precision: every product's operands, and the
    gradients they pass back, rounded to TF32 (the same on the CPU, which
    has no TF32, as on a card)."""

    def __init__(self):
        self.kind = "tf32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _TF32.apply(x)


TF32 = TF32Precision()


class AdamW(Adam):
    """torch.optim.AdamW's update, written out."""

    def __init__(self, lr: float, weight_decay: float = 0.01, **kw):
        super().__init__(lr, **kw)
        self.wd = weight_decay

    @torch.no_grad()
    def step(self, params, grads) -> None:
        for k in grads:
            params[k].mul_(1.0 - self.lr * self.wd)
        super().step(params, grads)


def ae_steps(P: Dict[str, torch.Tensor], lpips_P: dict,
             batches: Sequence[torch.Tensor], train: dict,
             prec: nets.Precision = nets.F32) -> dict:
    """len(batches) steps from the weights ``P`` (the encoder's and
    decoder's, copied); returns {'losses', 'first_grads', 'params'} over
    their parameters, as ``train.ldm_steps`` does.  With ``TF32`` cuDNN
    and cuBLAS may take TF32 too."""
    tf32 = prec.kind == "tf32"
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        P = {k: v.detach().clone().float() for k, v in P.items()
             if k.startswith(("encoder.", "decoder."))}
        names = [k for k in P if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        opt = AdamW(train["learning_rate"], train["weight_decay"])
        losses: List[float] = []
        first = None
        for x in batches:
            for k in names:
                P[k].requires_grad_(True)
            stats: dict = {}
            loss = ae_loss(P, lpips_P, x, train, stats, prec)
            grads = dict(zip(names, torch.autograd.grad(
                loss, [P[k] for k in names])))
            for k in names:
                P[k] = P[k].detach()
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            opt.step(P, grads)
            P.update(stats)
            losses.append(float(loss.detach()))
        return {"losses": losses, "first_grads": first,
                "params": {k: P[k] for k in names}}
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
