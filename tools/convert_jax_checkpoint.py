#!/usr/bin/env python3
"""Convert an orbax checkpoint of the JAX package into the PyTorch port's
format (``music_style_transfer_ldm_tpu_torch/training/checkpoint.py``).

    python tools/convert_jax_checkpoint.py JAX_CHECKPOINT_DIR OUT.pt

Runs where JAX and orbax are installed (it reads with the JAX package's
``restore_pytree``); the port itself never imports JAX.  The kind of
checkpoint is read from the payload's keys:

* ``kind`` (``import-torch --vggish/--lpips``, the kind as ASCII bytes):
  a feature checkpoint -> ``save_feature_checkpoint``;
* ``opt_state`` (``save_train_state``: the LDM trainer, the autoencoder
  trainer, a distillation stage in flight): a train state ->
  ``save_train_state``, Adam's ``mu``, ``nu`` and ``count`` and the
  injected learning rate carried into the port's optimizer state, each
  moment through its parameter's transpose, so ``--resume-from``
  continues from them;
* ``params`` of only ``encoder`` and ``decoder`` (``save_autoencoder``,
  phase 1's ``pretrained``): an autoencoder -> ``save_autoencoder``;
* otherwise a full LDM checkpoint (``params``, ``batch_stats``, optional
  ``ema_params`` and ``distill``) -> ``save_checkpoint``.

Weights go through ``interop/flax_weights.py``.  The LDM is the port's
default configuration (``build_ldm``); a payload whose shapes do not fit
it is refused.  Format 1 checkpoints (the JAX package's pre-interop UNet
deconv geometry) are refused: the port has format 2 only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

from music_style_transfer_ldm_tpu.training.checkpoint import (  # noqa: E402
    restore_pytree,
)
from music_style_transfer_ldm_tpu_torch.config import (  # noqa: E402
    default_config,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (  # noqa: E402,E501
    load_flax_convs, load_flax_variables,
)
from music_style_transfer_ldm_tpu_torch.losses.lpips import LPIPS  # noqa: E402
from music_style_transfer_ldm_tpu_torch.losses.vggish import (  # noqa: E402
    VGGishFeatures,
)
from music_style_transfer_ldm_tpu_torch.models.autoencoder import (  # noqa: E402,E501
    SpectrogramDecoder, SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import (  # noqa: E402
    build_ldm,
)
from music_style_transfer_ldm_tpu_torch.training import (  # noqa: E402
    checkpoint as ckpt_lib,
)
from music_style_transfer_ldm_tpu_torch.training.optim import (  # noqa: E402
    make_optimizer,
)
from music_style_transfer_ldm_tpu_torch.training.state import (  # noqa: E402
    TrainState,
)

AE = ("encoder", "decoder")


def _plain(x):
    """Restored metadata (0-d and 1-d arrays, nested dicts and lists) as
    Python numbers, lists and dicts."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return x.item() if np.ndim(x) == 0 else x.tolist()
    return x


def _find(tree, key: str):
    """The first dict in a restored optimizer state that has ``key``."""
    if isinstance(tree, dict):
        if key in tree:
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, key)
        if found is not None:
            return found
    return None


def _model(params: dict) -> nn.Module:
    """The port's module for a params tree: the LDM, or the autoencoder
    trainer's {encoder, decoder} (seed-0 weights, overwritten next)."""
    if set(params) == set(AE):
        latent = default_config().model.latent_dim
        return nn.ModuleDict({"encoder": SpectrogramEncoder(latent),
                              "decoder": SpectrogramDecoder(latent)})
    return build_ldm(dtype=torch.float32, device="cpu", seed=0)


def _named(model: nn.Module, tree: dict, batch_stats: dict) -> dict:
    """A flax params-layout tree (weights, an EMA, an Adam moment) as the
    port's {parameter name: tensor}, through the parameters' transposes."""
    holder = _model(tree)
    load_flax_variables(holder, {"params": tree, "batch_stats": batch_stats})
    return {k: p.detach().clone() for k, p in holder.named_parameters()}


def _fill_masked(moment: dict, params: dict):
    """A moment tree with its frozen (masked, restored as None) leaves
    zeroed, and the components that hold live leaves."""
    live = []

    def fill(m, p, comp):
        if isinstance(p, dict):
            return {k: fill(m.get(k) if isinstance(m, dict) else None, v,
                            comp) for k, v in p.items()}
        if m is None:
            return np.zeros_like(np.asarray(p))
        if comp not in live:
            live.append(comp)
        return m

    filled = {comp: fill(moment.get(comp), sub, comp)
              for comp, sub in params.items()}
    return filled, live


def _optimizer(model: nn.Module, payload: dict) -> torch.optim.Optimizer:
    """The port's optimizer over the trained components' parameters (in
    the trainers' order: the module's, without the frozen ones) with the
    JAX state's Adam moments, count and learning rate."""
    opt_state = payload["opt_state"]
    adam, inject = _find(opt_state, "mu"), _find(opt_state, "hyperparams")
    if adam is None or inject is None:
        raise SystemExit("the optimizer state holds no Adam moments or no "
                         "injected learning rate")
    hyper = inject["hyperparams"]
    params, stats = payload["params"], payload["batch_stats"]
    mu, live = _fill_masked(adam["mu"], params)
    nu, live_nu = _fill_masked(adam["nu"], params)
    if live != live_nu:
        raise SystemExit(f"mu trains {live}, nu trains {live_nu}")
    mu, nu = _named(model, mu, stats), _named(model, nu, stats)
    names = [n for n, _ in model.named_parameters()
             if n.split(".")[0] in live]
    kind = "adamw" if "weight_decay" in hyper else "adam"
    extra = ({"weight_decay": float(hyper["weight_decay"])}
             if kind == "adamw" else {})
    lr = float(hyper["learning_rate"])
    named = dict(model.named_parameters())
    opt = make_optimizer(kind, [named[n] for n in names], lr, **extra)
    state = opt.state_dict()
    step = torch.tensor(float(np.asarray(adam["count"])))
    state["state"] = {i: {"step": step.clone(), "exp_avg": mu[n],
                          "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    opt.load_state_dict(state)
    return opt


def _check_format(payload: dict, src) -> None:
    version = payload.get("format_version")
    version = int(np.asarray(version)) if version is not None else 1
    if version < ckpt_lib.FORMAT_VERSION:
        raise SystemExit(
            f"{src}: checkpoint format {version}: it was trained with the "
            "JAX package's pre-interop UNet deconv geometry (SAME padding), "
            "which the port does not have (format "
            f"{ckpt_lib.FORMAT_VERSION}, transpose convs in PyTorch's "
            "geometry); fine-tune it in the JAX package, save it again, "
            "then convert")


def convert(src: str | Path, out: str | Path) -> str:
    """Convert the orbax checkpoint ``src`` into the port's file ``out``;
    returns the kind ('feature', 'train_state', 'autoencoder' or
    'full')."""
    payload = restore_pytree(src)
    _check_format(payload, src)
    if "kind" in payload:
        kind = bytes(np.asarray(payload["kind"], np.uint8).ravel()).decode()
        module = {"vggish": VGGishFeatures, "lpips": LPIPS}[kind]()
        load_flax_convs(module, payload["params"])
        ckpt_lib.save_feature_checkpoint(out, kind, module.state_dict())
        return "feature"
    params, stats = payload["params"], payload.get("batch_stats", {})
    model = _model(params)
    load_flax_variables(model, {"params": params, "batch_stats": stats})
    ema = payload.get("ema_params")
    ema = None if ema is None else _named(model, ema, stats)
    if "opt_state" in payload:
        opt = _optimizer(model, payload)
        extra = _plain(payload["extra"]) if "extra" in payload else None
        ckpt_lib.save_train_state(
            out, TrainState(model=model, optimizer=opt,
                            step=int(np.asarray(payload["step"])),
                            ema_params=ema), extra=extra)
        return "train_state"
    if set(params) == set(AE):
        ckpt_lib.save_autoencoder(out, model.encoder, model.decoder)
        return "autoencoder"
    distill = payload.get("distill")
    ckpt_lib.save_checkpoint(out, model, ema_params=ema,
                             distill=None if distill is None
                             else _plain(distill))
    return "full"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="orbax checkpoint directory of the JAX "
                                "package")
    ap.add_argument("out", help="the port's checkpoint file to write")
    args = ap.parse_args(argv)
    kind = convert(args.src, args.out)
    print(f"converted {kind} checkpoint {args.src} -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
