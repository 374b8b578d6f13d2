#!/usr/bin/env python3
"""Readings behind the relative-L2 limits of
``tests/test_torch_autoencoder.py test_whole_step_gradients_match_jax_in_norm``.

For each metric and seed, one default AE step (KL on) of the PyTorch port
against the JAX package's, on the CPU in float32, per parameter in
relative L2 (max over the encoder's parameters and over the decoder's):

* ``port_vs_jax``: the port's gradients against JAX's;
* ``jax_self``: JAX's gradients at the input times (1 + 1e-5 noise)
  against JAX's at the input (the spread f32 rounding can cause);
* ``no_kl`` / ``no_perceptual``: the port with that term's weight set to
  0 against JAX with it (what a dropped term looks like).

    JAX_PLATFORMS=cpu python tools/torch_ae_grad_spread.py \\
        [--metrics lpips vggish none] [--seeds 3 4 5 6 7 8]

Prints one JSON object per (metric, seed).
"""

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_autoencoder as T  # noqa: E402


def split_max(err: dict) -> dict:
    return {comp: max(v for k, v in err.items() if k.startswith(comp + "."))
            for comp in T.AE}


def port_grads(trainer, state, x, **weights) -> dict:
    saved = {k: getattr(trainer, k) for k in weights}
    for k, v in weights.items():
        setattr(trainer, k, v)
    state, _ = trainer._step(copy.deepcopy(state), torch.tensor(x))
    for k, v in saved.items():
        setattr(trainer, k, v)
    return {k: v.numpy() for k, v in T._port_grads(state.model).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--metrics", nargs="+", default=sorted(T.METRICS))
    ap.add_argument("--seeds", nargs="+", type=int,
                    default=[3, 4, 5, 6, 7, 8])
    args = ap.parse_args()
    torch.set_num_threads(4)
    for metric in args.metrics:
        for seed in args.seeds:
            (_, trainer, jtr, state, _, holder, variables, fparams,
             x) = T._pair_state(metric, seed)
            want = T._jax_grads(jtr, variables, x, fparams, holder)
            noise = np.random.RandomState(9).randn(*x.shape)
            xp = (x * (1.0 + 1e-5 * noise)).astype(np.float32)
            jax_p = T._jax_grads(jtr, variables, xp, fparams, holder)
            row = {"metric": metric, "seed": seed,
                   "port_vs_jax": split_max(T._rel_l2(
                       port_grads(trainer, state, x), want)),
                   "jax_self": split_max(T._rel_l2(jax_p, want)),
                   "no_kl": split_max(T._rel_l2(
                       port_grads(trainer, state, x, kl_weight=0.0), want))}
            if trainer.feature is not None:
                row["no_perceptual"] = split_max(T._rel_l2(port_grads(
                    trainer, state, x, perceptual_weight=0.0), want))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
