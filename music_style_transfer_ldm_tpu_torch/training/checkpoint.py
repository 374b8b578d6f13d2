"""The port's checkpoint format.

One ``torch.save`` file holding

    {"params": state_dict, "ema_params": state_dict | None,
     "distill": dict | None, "format_version": 2}

with the keys of the JAX package's checkpoint payload: ``params`` is the
LDM's whole state dict (BatchNorm statistics included), ``ema_params``
an exponential moving average of its parameters when training kept one
(inference prefers it), and ``distill`` a progressively distilled
student's grid ({"steps", "t_max", "stages", "guidance"}).  Format 2 is
the JAX package's current one (transpose convs in PyTorch's geometry).

The JAX package's orbax checkpoints are not readable here: that needs
JAX, and waits for an offline converter.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

FORMAT_VERSION = 2


def _cpu_state(state: dict) -> dict:
    return {k: v.detach().float().cpu() if v.is_floating_point()
            else v.detach().cpu() for k, v in state.items()}


def save_checkpoint(path: str | Path, model, ema_params: Optional[dict] = None,
                    distill: Optional[dict] = None) -> None:
    """Write ``model``'s state (float32, on the CPU) and the optional EMA
    parameters and distillation metadata."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": _cpu_state(model.state_dict()),
                "ema_params": (None if ema_params is None
                               else _cpu_state(ema_params)),
                "distill": None if distill is None else dict(distill),
                "format_version": FORMAT_VERSION}, path)


def load_checkpoint(path: str | Path) -> dict:
    """Read a checkpoint written by ``save_checkpoint`` (tensors only, no
    pickled code)."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a checkpoint of the port (no "
                         "'params'); orbax checkpoints of the JAX package "
                         "are not readable yet")
    version = int(payload.get("format_version", 0))
    if version != FORMAT_VERSION:
        raise ValueError(f"{path}: checkpoint format {version}, expected "
                         f"{FORMAT_VERSION}")
    return payload
