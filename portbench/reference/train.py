"""The plain reference of the LDM training step, in float32 with TF32
off, and of Adam.

One step on a batch of (content, style) unit images:

* t ~ U{0..T-1} and the q-sample noise, drawn in that order from a
  generator seeded by splitmix64(seed << 32 | step) for the configured
  batch of rows;
* the frozen encoder (BatchNorm on its running statistics) gives z0;
  z_t = sqrt(ab_t) z0 + sqrt(1 - ab_t) eps; the UNet predicts eps from
  z_t, t and the style pyramid; x0 = (z_t - sqrt(1 - ab_t) eps_hat) /
  sqrt(ab_t); the decoder, its BatchNorm on the batch's statistics,
  reconstructs (x + 1) / 2;
* loss = MSE(eps_hat, eps)
       + MSE(recon, content) + 0.1 LPIPS(content, recon) + 0.01 KL(z0)
       + 3.0 VGGish(recon, style), the last without a gradient;
* Adam (betas 0.9 / 0.999, eps 1e-8, bias-corrected) on every parameter
  outside the encoder.

LPIPS: each AlexNet map unit-normalised over channels (+1e-10), squared
difference, a 1x1 head, the spatial and batch mean, summed over maps;
inputs replicated to three channels and mapped to [-1, 1].  VGGish: each
of six maps standardised per sample (population std, + 1e-8), the MSE,
averaged over maps and the batch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import nets
from portbench.reference.sample import alpha_bars

_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    z = (((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def draws(seed: int, step: int, rows: int, model: dict, device):
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed, step))
    lat = model["image_size"] // 8
    t = torch.randint(0, model["num_timesteps"], (rows,), device=device,
                      generator=g)
    noise = torch.randn((rows, lat, lat, model["latent_dim"]),
                        device=device, generator=g)
    return t, noise.permute(0, 3, 1, 2)


def mse(a, b):
    return ((a - b) ** 2).mean()


def kl(z):
    z2 = z * z
    return (0.5 * (z2 - 1.0 - torch.log(z2 + 1e-8))).mean()


def lpips(P: dict, a: torch.Tensor, b: torch.Tensor,
          prec: nets.Precision = nets.F32) -> torch.Tensor:
    def prep(x):
        return 2.0 * x[:, None].expand(-1, 3, -1, -1) - 1.0

    total = torch.zeros((), device=a.device)
    for i, (xa, xb) in enumerate(zip(nets.alex_maps(P, prep(a), prec),
                                     nets.alex_maps(P, prep(b), prec))):
        na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-10)
        nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-10)
        d = torch.nn.functional.conv2d(prec.q((na - nb) ** 2),
                                       prec.q(P[f"lin{i}.weight"]))
        total = total + d.mean()
    return total


def vggish_distance(P: dict, pred: torch.Tensor, target: torch.Tensor,
                    prec: nets.Precision = nets.F32) -> torch.Tensor:
    total = torch.zeros((), device=pred.device)
    fp = nets.vggish_maps(P, pred[:, None], prec)
    ft = nets.vggish_maps(P, target[:, None], prec)
    for p, t in zip(fp, ft):
        p, t = p.flatten(1), t.flatten(1)
        sp = p.std(1, unbiased=False)
        st = t.std(1, unbiased=False)
        d = p / (sp + 1e-8)[:, None] - t / (st + 1e-8)[:, None]
        total = total + (d * d).mean(1).mean()
    return total / len(fp)


def ldm_losses(P: Dict[str, torch.Tensor], trunks: dict, content, style,
               t, eps, model: dict, weights: dict,
               new_stats: dict, prec: nets.Precision = nets.F32) -> dict:
    """The step's losses; content, style [B, 128, 128] unit images; t
    [B]; eps [B, latent, 16, 16]."""
    ab = torch.as_tensor(alpha_bars(model), device=content.device)[t]
    ab = ab.reshape(-1, 1, 1, 1)
    z0 = nets.encoder(P, content[:, None], prec)
    s5, s6 = nets.style_pyramid(P, style[:, None], prec)
    z_t = torch.sqrt(ab) * z0 + torch.sqrt(1.0 - ab) * eps
    eps_hat = nets.unet(P, z_t, t, s5, s6, model["attn_num_heads"], prec)
    x0 = (z_t - torch.sqrt(1.0 - ab) * eps_hat) / torch.sqrt(ab)
    recon = (nets.decoder(P, x0, True, new_stats, prec)[:, 0] + 1.0) / 2.0
    denoising = mse(eps_hat, eps)
    compression = (mse(recon, content)
                   + weights["perceptual_weight"] * lpips(
                       trunks["lpips"], content, recon, prec)
                   + weights["kl_weight"] * kl(z0))
    with torch.no_grad():
        style_l = vggish_distance(trunks["vggish"], recon, style, prec)
    total = denoising + compression + weights["style_loss_weight"] * style_l
    return {"total_loss": total, "denoising_loss": denoising,
            "compression_loss": compression, "style_loss": style_l}


class Adam:
    """torch.optim.Adam's update, written out."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.step_count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.step_count += 1
        c1 = 1.0 - self.b1 ** self.step_count
        c2 = 1.0 - self.b2 ** self.step_count
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            params[k].addcdiv_(m, denom, value=-self.lr / c1)


def ldm_steps(P: Dict[str, torch.Tensor], trunks: dict,
              batches: Sequence[tuple], seed: int, model: dict,
              train: dict, prec: nets.Precision = nets.F32) -> dict:
    """Run len(batches) steps from the weights ``P`` (copied); returns
    {'losses': [total per step], 'first_grads': {name: grad of step 1},
    'params': {name: tensor after the last step}} over the trainable
    parameters (every one outside the encoder)."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        P = {k: v.detach().clone().float() for k, v in P.items()}
        names = [k for k in P if not k.startswith("encoder.")
                 and not k.endswith(("running_mean", "running_var",
                                     "num_batches_tracked"))]
        opt = Adam(train["learning_rate"])
        losses: List[float] = []
        first = None
        for step, (content, style) in enumerate(batches):
            t, eps = draws(seed, step, train["batch_size"], model,
                           content.device)
            t, eps = t[:content.shape[0]], eps[:content.shape[0]]
            for k in names:
                P[k].requires_grad_(True)
            stats: dict = {}
            out = ldm_losses(P, trunks, content, style, t, eps, model,
                             train, stats, prec)
            grads = torch.autograd.grad(out["total_loss"],
                                        [P[k] for k in names],
                                        allow_unused=True)
            grads = {k: (g if g is not None else torch.zeros_like(P[k]))
                     for k, g in zip(names, grads)}
            for k in names:
                P[k] = P[k].detach()
            if first is None:
                first = {k: g.clone() for k, g in grads.items()}
            opt.step(P, grads)
            P.update(stats)
            losses.append(float(out["total_loss"].detach()))
        return {"losses": losses, "first_grads": first,
                "params": {k: P[k] for k in names}}
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = old
