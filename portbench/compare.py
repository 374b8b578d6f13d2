"""The numbers that decide ``correct``, and the work counts of the
model-level utilisation metrics.  Each configuration's ``limits`` names
the numbers a cell compares; the others are read for the look behind a
limit (``calibrate.py``, PERF.md).

Serving, per checked clip:

* ``image_gap``: the largest absolute difference of a served image's
  pixels (unit range) from the reference's transfer of the same inputs,
  the worst clip;
* ``audio_gap``: the largest absolute difference of the served audio
  from the reference's inversion of the served image, relative to that
  clip's peak: ``audio_gap_median`` the median clip (compared),
  ``audio_gap`` the worst (Griffin-Lim turns rounding in a few clips
  into gaps as wide as a lower precision's).

Training, over the first three steps:

* ``change_gap_median``: the parameters' change over the steps, per
  leaf | |d| - |d_ref| | / max(|d_ref|, median |d_ref|), the median
  leaf, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a bias that softmax or a train-mode
  BatchNorm makes blind moves under Adam by round-off alone);
* ``style_term_gap``: the style distance the program returned (kernels E
  and D) against the reference's VGGish distance of the same images,
  relative, the mean of the steps;
* read, not compared: ``loss_gap`` (the worst step's relative loss gap),
  ``grad_gap`` (the step-1 gradient as Adam got it, its first moment
  over (1 - beta1), the same measure, the worst leaf), ``change_gap``
  (the worst leaf), with the worst leaves' names.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import audio as ref_audio


def clip_gaps(img: torch.Tensor, ref_img: torch.Tensor,
              aud: torch.Tensor, ref_aud: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Each checked clip's gaps, [n] per measure."""
    d = (img.float() - ref_img.float()).flatten(1)
    peak = ref_aud.float().abs().amax(1).clamp(min=1e-12)
    return {"image_gap": d.abs().amax(1),
            "audio_gap": (aud.float() - ref_aud.float()).abs().amax(1)
            / peak}


def serve_gaps(per_clip: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    cat = {k: torch.cat([p[k] for p in per_clip]).cpu() for k in per_clip[0]}
    return {"image_gap": float(cat["image_gap"].max()),
            "audio_gap": float(cat["audio_gap"].max()),
            "audio_gap_median": float(cat["audio_gap"].median())}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep=None) -> Dict[str, float]:
    names = [k for k in ref if keep is None or k in keep]
    pn = torch.stack([prog[k].float().norm() for k in names])
    rn = torch.stack([ref[k].float().norm() for k in names])
    floor = torch.maximum(rn, rn.median())
    gaps = ((pn - rn).abs() / floor.clamp(min=1e-30)).tolist()
    return dict(zip(names, gaps))


def train_gaps(prog: dict, ref: dict, theta0: Dict[str, torch.Tensor]
               ) -> dict:
    """prog and ref: {'losses', 'first_grads', 'params'} (params after
    the last checked step); theta0 the weights both started from."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    gnorm = {k: g.float().norm() for k, g in ref["first_grads"].items()}
    med = torch.stack(list(gnorm.values())).median()
    moved = {k for k, n in gnorm.items() if n >= 1e-3 * med}
    dp = {k: prog["params"][k].float() - theta0[k].float()
          for k in ref["params"]}
    dr = {k: ref["params"][k].float() - theta0[k].float()
          for k in ref["params"]}
    grads = _leaf_gaps(prog["first_grads"], ref["first_grads"])
    change = _leaf_gaps(dp, dr, moved)
    worst_g = max(grads, key=grads.get)
    worst_c = max(change, key=change.get)
    return {"loss_gap": max(losses), "grad_gap": grads[worst_g],
            "change_gap": change[worst_c],
            "change_gap_median": float(torch.tensor(list(change.values()))
                                       .median()),
            "grad_worst_leaf": worst_g, "change_worst_leaf": worst_c,
            "left_out": sorted(set(dr) - moved)}


def style_term_gap(terms, vggish: dict, prec=None) -> float:
    """The mean over the checked steps of |d - d_ref| / d_ref: d the
    style distance the program returned, d_ref the reference's VGGish
    distance of the same images (in ``prec``, default float32)."""
    from portbench.reference import nets, train as ref_train
    prec = prec or nets.F32
    gaps = []
    with torch.no_grad():
        for recon, style, value in terms:
            ref = float(ref_train.vggish_distance(vggish, recon, style, prec))
            gaps.append(abs(value - ref) / max(abs(ref), 1e-30))
    return sum(gaps) / len(gaps)


def clip_flops(P: dict, cfg: dict, device) -> float:
    """FLOPs of one served clip, counted by FlopCounterMode over the
    reference (matrix products and convolutions; no FFT is counted)."""
    from portbench.reference import sample
    size = cfg["model"]["image_size"]
    x = torch.zeros((1, size, size), device=device)

    def clip():
        img = sample.transfer(P, x, x, [0], cfg["model"],
                              cfg["serve"]["steps"])
        ref_audio.image_to_audio(img, dict(cfg["serve"]["audio"],
                                           seconds=3.0))
    return step_flops(clip)


def step_flops(fn) -> float:
    """FLOPs counted by FlopCounterMode while ``fn()`` runs."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())
