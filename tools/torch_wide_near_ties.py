#!/usr/bin/env python3
"""Readings behind the decoder's relative-L2 bar of
``tests/test_torch_sequence_parallel.py``: on the CPU, in float32, the
LDM step on the wide 64 x 256 batch of that test's ``wide`` fixture,
per parameter.

* ``port_vs_jax``: the port's one-process step against the JAX step on
  the same injected draws (max abs error / max |grad|, and relative L2,
  the worst three parameters);
* ``float64``: the decoder's gradients again from a float64 copy of the
  decoder on the same z_0 prediction (the MSE term, the only one that
  reaches the decoder without the perceptual terms), against the port's
  float32 step and against JAX's: which side rounding put where;
* ``gate_flips``: the ReLU gates after the decoder's two BatchNorms that
  differ between the float32 and the float64 decoder, and how many
  pre-ReLU values lie within 1e-5 of 0.

    JAX_PLATFORMS=cpu python tools/torch_wide_near_ties.py [--seed 0]

Prints one JSON object.  About a minute (JAX's step at 64 x 256).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_sequence_parallel as T  # noqa: E402
from music_style_transfer_ldm_tpu.config import (  # noqa: E402
    default_config as jax_config,
)
from music_style_transfer_ldm_tpu.parallel import (  # noqa: E402
    make_mesh as jax_make_mesh,
)
from music_style_transfer_ldm_tpu.training import (  # noqa: E402
    LDMTrainer as JaxTrainer,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (  # noqa: E402,E501
    export_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import build_ldm  # noqa: E402,E501
from music_style_transfer_ldm_tpu_torch.training import (  # noqa: E402
    LDMTrainer,
)

DECODER = ("deconv1.weight", "deconv2.weight", "deconv3.weight",
           "bn1.weight", "bn1.bias", "bn2.weight", "bn2.bias")


def errors(got: dict, want: dict, names) -> list:
    """[(max abs error / max |want|, relative L2, name)], worst first."""
    out = []
    for k in names:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        out.append((float(np.abs(g - w).max() / np.abs(w).max()),
                    float(np.linalg.norm(g - w) / np.linalg.norm(w)), k))
    return sorted(out, reverse=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    rng = np.random.RandomState(args.seed)
    cfg = T.tiny()
    ldm = build_ldm(cfg, device="cpu", seed=0)
    T._randomise_stats(ldm, rng)
    c, s = (rng.rand(T.B, T.H, T.W, 1).astype(np.float32) for _ in range(2))
    t = np.asarray([3, 50, 120, 199], np.int32)
    variables = jax.tree_util.tree_map(jnp.asarray,
                                       export_flax_variables(ldm))
    jtr = JaxTrainer(T.tiny(jax_config()),
                     mesh=jax_make_mesh((1, 1), devices=jax.devices()[:1]),
                     perceptual=False)
    drng = jax.random.PRNGKey(5)
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bs, cc, ss, tt: jtr._losses(p, bs, cc, ss, tt, drng,
                                              (None, None)),
        has_aux=True))(variables["params"], variables["batch_stats"], c, s, t)
    noise = np.asarray(jtr.model.apply(
        variables, c, s, t, train=True, frozen_encoder=True,
        rngs={"diffusion": drng}, mutable=["batch_stats"])[0]["noise"])
    jax_grads, _ = T._as_port(cfg, jgrads, variables["batch_stats"])

    tr = LDMTrainer(cfg, perceptual=False, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(ldm.state_dict())
    st, _ = tr._step(st, torch.tensor(c), torch.tensor(s),
                     t=torch.tensor(t).long(), noise=torch.tensor(noise))
    port = {k: p.grad.numpy() for k, p in st.model.named_parameters()
            if p.grad is not None}
    weights = [k for k, v in jax_grads.items()
               if not k.startswith("encoder.")
               and np.abs(v).max() > 1e-5 * max(
                   np.abs(w).max() for w in jax_grads.values())]

    # the decoder alone, float32 and float64, on the step's z_0 prediction
    model = build_ldm(cfg, device="cpu", seed=0)
    model.load_state_dict(ldm.state_dict())
    with torch.no_grad():
        out = model(torch.tensor(c), torch.tensor(s),
                    torch.tensor(t).long(), train=True, frozen_encoder=True,
                    noise=torch.tensor(noise))
    ab = model.schedule.alpha_bars.double()[torch.tensor(t).long()]
    ab = ab.reshape(-1, 1, 1, 1)
    z_t = out["z_t"].permute(0, 3, 1, 2).double()
    eps = out["noise_pred"].permute(0, 3, 1, 2).double()
    z0_pred = (z_t - torch.sqrt(1 - ab) * eps) / torch.sqrt(ab)
    target = torch.tensor(c).permute(0, 3, 1, 2).double()
    pre_relu, grads = {}, {}
    for dtype in (torch.float32, torch.float64):
        fresh = build_ldm(cfg, device="cpu", seed=0)
        fresh.load_state_dict(ldm.state_dict())
        dec = fresh.decoder.to(dtype).requires_grad_(True)
        for name in ("bn1", "bn2"):
            getattr(dec, name).register_forward_hook(
                lambda mod, inp, o, key=(dtype, name):
                pre_relu.__setitem__(key, o.detach().double()))
        # the BatchNorm computes in float32 whatever its input: a float64
        # decoder here runs the layers in float64 around it
        rec = (dec(z0_pred.to(dtype), train=True) + 1.0) / 2.0
        ((rec.double() - target) ** 2).mean().backward()
        grads[dtype] = {"decoder." + k: p.grad.double().numpy()
                        for k, p in dec.named_parameters()}
    names = ["decoder." + k for k in DECODER]
    flips = {}
    for name in ("bn1", "bn2"):
        a, b = pre_relu[(torch.float32, name)], pre_relu[(torch.float64,
                                                         name)]
        flips[name] = {"flipped": int(((a > 0) != (b > 0)).sum()),
                       "within_1e-5": int((b.abs() < 1e-5).sum()),
                       "values": int(b.numel())}
    f64 = grads[torch.float64]
    print(json.dumps({
        "seed": args.seed,
        "port_vs_jax": errors(port, jax_grads, weights)[:3],
        "float64": {"port_step": errors(port, f64, names)[:3],
                    "jax_step": errors(jax_grads, f64, names)[:3],
                    "float32_decoder": errors(grads[torch.float32], f64,
                                              names)[:3]},
        "gate_flips": flips}))


if __name__ == "__main__":
    main()
