"""Kernel D's forward: each map's pred and target read once and its
metrics written, at the HBM rate, over the profiler time of its
launches, in percent.  A trunk call launches it once per map (six)."""
from portbench.yardstick import HBM, kernel, normalized_mse_bytes, peak


def read(ctx):
    count, secs = kernel(ctx, "nm_forward_kernel")
    hbm = peak(HBM, ctx.get("device_kind", ""))
    if count < 6 or secs <= 0 or not hbm:
        return None
    mix, model = ctx["cell"].traffic, ctx["cell"].config["model"]
    per_call = normalized_mse_bytes(mix["batch_size"], model["image_size"])
    return 100.0 * (count / 6) * per_call / hbm / secs
