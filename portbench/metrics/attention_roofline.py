"""The fused attention kernels behind ``F.scaled_dot_product_attention``
(cuDNN's or flash's; the UNet's self- and cross-attention): the
operations of their q k^T and weights-times-v products
(``riffusion_cost.attention_flops_per_row``, one UNet call of one row)
at the bf16 peak, over the kernels' profiler time, in percent.
The UNet calls in the profile are kernel B's launches (one a DDIM step);
the rows a call are the engine's mean dispatched bucket, twice under
guidance."""
from portbench.riffusion_cost import attention_flops_per_row
from portbench.yardstick import PEAK_BF16, kernel, peak

KERNELS = ("fort_native_sdpa", "flash_fwd")


def read(ctx):
    calls, _ = kernel(ctx, "ddim_update")
    launches, secs = kernel(ctx, *KERNELS)
    stats = ctx.get("stats") or {}
    flops = peak(PEAK_BF16, ctx.get("device_kind", ""))
    if not calls or not launches or secs <= 0 or not stats.get("batches") \
            or not flops:
        return None
    cfg = ctx["cell"].config
    rows = (stats["rows_dispatched"] + stats["padded_slots"]) \
        / stats["batches"]
    rows *= 2 if cfg["serve"]["guidance"] != 1.0 else 1
    work = calls * rows * attention_flops_per_row(cfg["model"])
    return 100.0 * work / flops / secs
