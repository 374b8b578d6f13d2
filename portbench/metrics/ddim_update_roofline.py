"""Kernel B: its bytes (f32 latent read and written, bf16 eps read) at
the HBM rate, over its profiler time, per launch, in percent.  The
bucket is the engine's mean dispatched bucket."""
from portbench.yardstick import HBM, ddim_update_bytes, kernel, peak


def read(ctx):
    count, secs = kernel(ctx, "ddim_update")
    stats, hbm = ctx.get("stats") or {}, peak(HBM, ctx.get("device_kind", ""))
    if not count or secs <= 0 or not stats.get("batches") or not hbm:
        return None
    bucket = round((stats["requests"] + stats["padded_slots"])
                   / stats["batches"])
    return 100.0 * count * ddim_update_bytes(bucket) / hbm / secs
