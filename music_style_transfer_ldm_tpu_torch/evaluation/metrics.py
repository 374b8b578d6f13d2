"""Training-independent transfer-quality metrics.

These share nothing with the training objective:

* log-mel band statistics distance: the images are log-mel
  spectrograms, so timbre lives in the distribution of energy over mel
  bands; a diagonal 2-moment Frechet distance between per-band (mean,
  std) profiles says how far the output's spectral envelope moved toward
  the style corpus;
* (batch) spectral convergence ||A - B||_F / ||B||_F, for content
  preservation (transfer vs content) and style approach (transfer vs
  style);
* differently seeded VGGish trunks: the training trunk's topology from
  independent random inits (random projections preserve distances), so
  agreement across seeds rules out the training trunk's own projection
  being the only axis that moved.

Images are in [0, 1] ([N, H, W] or [N, H, W, 1]), as the dataset and
serving layers produce them.  The band and spectral metrics are numpy on
the host, as in the JAX package.  The trunk metrics run on ``device``
(the card unless the caller asks for the CPU): ``style_distances_
multiseed`` through ``losses/vggish.py``'s distance, which on the card
resolves to kernel E's f32 value-only form with kernel D's per-layer
metrics inside it (``impl="plain"`` forces the plain version), and
``trunk_embeddings`` through the trunk's feature maps.  ``trunks`` maps a
seed to a ``VGGishFeatures`` state dict; a seed it lacks gets a random
trunk from that seed (PyTorch's generator, so not the JAX package's
trunk of the same seed).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.losses.feature import (
    build_feature_metric,
)


def _squeeze(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    if x.ndim == 4:
        x = x[..., 0]
    if x.ndim == 2:
        x = x[None]
    return x


def band_statistics(imgs: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-mel-band energy statistics over (samples, time).

    imgs: [N, n_mels, T] in [0, 1] (unit-scaled dB).  Returns mean and std
    vectors of length n_mels — the spectral envelope profile of the set.
    """
    x = _squeeze(imgs)
    return {"mean": x.mean(axis=(0, 2)), "std": x.std(axis=(0, 2))}


def log_mel_stats_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Diagonal 2-moment Frechet distance between the band-statistics
    profiles of two image sets: ||mu_a - mu_b||^2 + ||sd_a - sd_b||^2;
    0 when the sets share their per-band energy distribution."""
    sa, sb = band_statistics(a), band_statistics(b)
    return float(((sa["mean"] - sb["mean"]) ** 2).sum()
                 + ((sa["std"] - sb["std"]) ** 2).sum())


def batch_spectral_convergence(est: np.ndarray, ref: np.ndarray) -> float:
    """||EST - REF||_F / ||REF||_F averaged over the batch (0 identical;
    ~1 unrelated energy layouts)."""
    e, r = _squeeze(est), _squeeze(ref)
    num = np.linalg.norm((e - r).reshape(len(e), -1), axis=1)
    den = np.linalg.norm(r.reshape(len(r), -1), axis=1)
    return float(np.mean(num / np.maximum(den, 1e-12)))


def _nhwc(x, device) -> torch.Tensor:
    return torch.as_tensor(_squeeze(x)[..., None], dtype=torch.float32,
                           device=device)


def style_distances_multiseed(
        content: np.ndarray, style: np.ndarray, transfer: np.ndarray,
        seeds: Sequence[int] = (11, 29), device="cuda",
        trunks: Optional[Dict[int, dict]] = None, impl: str = "auto",
) -> Dict[int, Tuple[float, float]]:
    """{seed: (d(content, style), d(transfer, style))}, the f32 VGGish
    distance under each seed's trunk, without a gradient."""
    trunks = trunks or {}
    out = {}
    for seed in seeds:
        m = build_feature_metric("vggish", torch.float32, seed=seed,
                                 device=device, params=trunks.get(seed),
                                 impl=impl)
        dev = next(m.module.parameters()).device
        c, s, t = (_nhwc(x, dev) for x in (content, style, transfer))
        with torch.no_grad():
            out[seed] = (float(m.distance(c, s)), float(m.distance(t, s)))
    return out


def style_distance_reductions_multiseed(
        content: np.ndarray, style: np.ndarray, transfer: np.ndarray,
        seeds: Sequence[int] = (11, 29), device="cuda",
        trunks: Optional[Dict[int, dict]] = None) -> Dict[int, float]:
    """Style-distance reduction (%) under independently seeded VGGish
    trunks: 100 * (1 - d(transfer, style) / d(content, style))."""
    dists = style_distances_multiseed(content, style, transfer, seeds,
                                      device, trunks)
    return {seed: round(100.0 * (1.0 - got / base), 1)
            for seed, (base, got) in dists.items()}


def trunk_embeddings(imgs: np.ndarray, seed: int = 11, dtype=None,
                     device="cuda", params: Optional[dict] = None
                     ) -> np.ndarray:
    """One embedding per image, [N, 512] float64: the spatially pooled
    final feature map of a seeded (or given) VGGish trunk — a Frechet
    Audio Distance's embedding (Kilgour et al. 2019) with a fixed random
    trunk in place of the pretrained one."""
    module = build_feature_metric("vggish", dtype or torch.float32,
                                  seed=seed, device=device,
                                  params=params).module
    x = _nhwc(imgs, next(module.parameters()).device)
    with torch.no_grad():
        feats = module(x)
    return feats[-1].float().mean(dim=(1, 2)).double().cpu().numpy()


def frechet_distance(a_emb: np.ndarray, b_emb: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Frechet distance between Gaussians fit to two embedding sets:
    ||mu_a - mu_b||^2 + tr(Ca + Cb - 2 (Ca Cb)^1/2), with
    tr((Ca Cb)^1/2) = sum(sqrt(eig(S Cb S))), S = Ca^1/2 (symmetric PSD,
    so the eigenvalues are real; the clip only removes numerical
    negatives).  With N < C samples the covariances are rank-deficient:
    compare values at the same N, not absolutely."""
    a = np.asarray(a_emb, np.float64)
    b = np.asarray(b_emb, np.float64)
    mu_a, mu_b = a.mean(0), b.mean(0)
    ca = np.cov(a, rowvar=False) + eps * np.eye(a.shape[1])
    cb = np.cov(b, rowvar=False) + eps * np.eye(b.shape[1])
    wa, va = np.linalg.eigh(ca)
    s = (va * np.sqrt(np.clip(wa, 0.0, None))) @ va.T
    wm = np.linalg.eigvalsh(s @ cb @ s)
    tr_sqrt = np.sum(np.sqrt(np.clip(wm, 0.0, None)))
    d2 = (np.sum((mu_a - mu_b) ** 2) + np.trace(ca) + np.trace(cb)
          - 2.0 * tr_sqrt)
    return float(max(d2, 0.0))


def fad_metrics(content: np.ndarray, transfer: np.ndarray,
                style_corpus: np.ndarray, seed: int = 11, device="cuda",
                trunks: Optional[Dict[int, dict]] = None
                ) -> Dict[str, float]:
    """FAD(transfer, style corpus) before and after: how far the output
    distribution moved toward the style class."""
    params = (trunks or {}).get(seed)
    e_c, e_t, e_s = (trunk_embeddings(x, seed=seed, device=device,
                                      params=params)
                     for x in (content, transfer, style_corpus))
    base = frechet_distance(e_c, e_s)
    got = frechet_distance(e_t, e_s)
    return {
        "fad_transfer_vs_style_corpus": round(got, 4),
        "fad_content_vs_style_corpus": round(base, 4),
        "fad_reduction_pct": round(100.0 * (1.0 - got / max(base, 1e-12)),
                                   1),
    }


def _zscore_set(x: np.ndarray) -> np.ndarray:
    """Remove a set's global level and contrast (one affine per set, not
    per image): isolates envelope shape from overall brightness."""
    g = _squeeze(x)
    return (g - g.mean()) / (g.std() + 1e-12)


def independent_transfer_metrics(content: np.ndarray, style: np.ndarray,
                                 transfer: np.ndarray,
                                 style_corpus: np.ndarray | None = None,
                                 seeds: Sequence[int] = (11, 29),
                                 device="cuda",
                                 trunks: Optional[Dict[int, dict]] = None
                                 ) -> Dict[str, object]:
    """The training-independent metric block of an evaluation report.

    style_corpus defaults to the paired style batch.  The raw band-stats
    distance comes beside a level/contrast-normalised (envelope shape)
    variant and the global level and contrast themselves: diffusion
    decoders often compress the output's dynamic range, which the raw
    distance mixes with envelope-shape mismatch."""
    corpus = style if style_corpus is None else style_corpus
    lm_base = log_mel_stats_distance(content, corpus)
    lm_got = log_mel_stats_distance(transfer, corpus)
    lm_shape_base = log_mel_stats_distance(_zscore_set(content),
                                           _zscore_set(corpus))
    lm_shape_got = log_mel_stats_distance(_zscore_set(transfer),
                                          _zscore_set(corpus))
    t, c = _squeeze(transfer), _squeeze(corpus)
    return {
        "logmel_stats_distance_transfer_vs_style_corpus": round(lm_got, 6),
        "logmel_stats_distance_content_vs_style_corpus": round(lm_base, 6),
        "logmel_stats_reduction_pct": round(
            100.0 * (1.0 - lm_got / max(lm_base, 1e-12)), 1),
        "logmel_shape_distance_transfer_vs_style_corpus": round(
            lm_shape_got, 6),
        "logmel_shape_distance_content_vs_style_corpus": round(
            lm_shape_base, 6),
        "logmel_shape_reduction_pct": round(
            100.0 * (1.0 - lm_shape_got / max(lm_shape_base, 1e-12)), 1),
        "global_level_transfer_vs_corpus": [round(float(t.mean()), 4),
                                            round(float(c.mean()), 4)],
        "global_contrast_transfer_vs_corpus": [round(float(t.std()), 4),
                                               round(float(c.std()), 4)],
        "spectral_convergence_transfer_vs_content": round(
            batch_spectral_convergence(transfer, content), 4),
        "spectral_convergence_transfer_vs_style": round(
            batch_spectral_convergence(transfer, style), 4),
        "spectral_convergence_content_vs_style_baseline": round(
            batch_spectral_convergence(content, style), 4),
        "vggish_multiseed_style_reduction_pct":
            style_distance_reductions_multiseed(content, style, transfer,
                                                seeds, device, trunks),
        **fad_metrics(content, transfer, corpus, seed=seeds[0],
                      device=device, trunks=trunks),
    }
