"""The yardstick the metric readers share: the card's published peaks,
the work of the hand-written kernels as functions of their shapes, and
small readers of spans, latencies and the trace.

Peaks are NVIDIA's H100 data-sheet figures (dense, no sparsity), matched
by a substring of ``torch.cuda.get_device_name()``, most specific first.
A kernel's bound is the larger of its operations at the peak rate and
its bytes, each input read once and each output written once, at the
HBM rate; its roofline share is that bound over its measured time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from portbench.tracing import kernel_stats

PEAK_BF16 = (("h100 pcie", 756e12), ("h100 nvl", 835e12), ("h100", 989e12))
HBM = (("h100 pcie", 2.0e12), ("h100 nvl", 3.9e12), ("h100", 3.35e12))


def peak(table, kind: str) -> Optional[float]:
    kind = str(kind).lower()
    return next((v for k, v in table if k in kind), None)


# ---------------------------------------------------------------- kernels

def ddim_update_bytes(batch: int, latent: int = 32, size: int = 16,
                      eps_bytes: int = 2) -> int:
    """Kernel B in place: the f32 latent read and written, eps read."""
    n = batch * latent * size * size
    return n * (4 + 4 + eps_bytes)


VGGISH_CONVS = ((1, 64, 0), (64, 128, 1), (128, 256, 2), (256, 256, 2),
                (256, 512, 3), (512, 512, 3))   # (cin, cout, pools before)


def vggish_trunk_cost(batch: int, size: int, itemsize: int = 2) -> dict:
    """Kernel E's value-only call on ``batch`` pred and ``batch`` target
    images: conv2 ... conv4_2 on both branches (2 flops a multiply-add);
    bytes: conv1's output read, the weights read, the [B, 6] metrics
    written."""
    flops, wbytes = 0, 0
    for i, (cin, cout, pools) in enumerate(VGGISH_CONVS):
        if i == 0:
            continue
        px = (size >> pools) ** 2
        flops += 2 * 9 * cin * cout * px * 2 * batch
        wbytes += 9 * cin * cout * itemsize
    f1 = 2 * batch * size * size * 64 * itemsize
    return {"flops": flops, "bytes": f1 + wbytes + 24 * batch}


def normalized_mse_bytes(batch: int, size: int, itemsize: int = 2) -> int:
    """Kernel D's forward over the six VGGish maps of one trunk call:
    each map's pred and target read once, m and the [B, 6] statistics
    written."""
    total = 0
    for cin, cout, pools in VGGISH_CONVS:
        n = cout * (size >> pools) ** 2
        total += 2 * batch * n * itemsize + 28 * batch
    return total


# ---------------------------------------------------------------- readers

def span_mean_ms(ctx: dict, name: str) -> Optional[float]:
    spans = ctx.get("spans")
    if spans is None:
        return None
    d = spans.durations(name)
    return 1e3 * float(np.mean(d)) if d else None


def percentile_ms(values, q: float) -> Optional[float]:
    return 1e3 * float(np.percentile(values, q)) if len(values) else None


def idle_fraction(ctx: dict) -> Optional[float]:
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def kernel(ctx: dict, *needles: str):
    return kernel_stats(ctx.get("trace"), *needles)


def mfu_percent(ctx: dict, flops_per_unit: Optional[float], units: float,
                table=PEAK_BF16) -> Optional[float]:
    p = peak(table, ctx.get("device_kind", ""))
    if not flops_per_unit or not p or ctx["window_s"] <= 0:
        return None
    return 100.0 * flops_per_unit * units / ctx["window_s"] / p
