"""Kernel B on Riffusion's latents: its bytes (the f32 latent read and
written, the guided eps read, f32 under guidance) at the HBM rate, over
its profiler time, per launch, in percent.  A launch's rows are the
engine's mean dispatched bucket (the update runs on the guided eps, so
one row a clip)."""
from portbench.yardstick import HBM, ddim_update_bytes, kernel, peak


def read(ctx):
    count, secs = kernel(ctx, "ddim_update")
    stats, hbm = ctx.get("stats") or {}, peak(HBM, ctx.get("device_kind", ""))
    if not count or secs <= 0 or not stats.get("batches") or not hbm:
        return None
    cfg = ctx["cell"].config
    m, sv = cfg["model"], cfg["serve"]
    rows = (stats["rows_dispatched"] + stats["padded_slots"]) \
        / stats["batches"]
    side = m["image_size"] >> (len(m["vae"]["block_out_channels"]) - 1)
    n = ddim_update_bytes(1, m["vae"]["latent_channels"], side,
                          4 if sv["guidance"] != 1.0 else 2)
    return 100.0 * count * rows * n / hbm / secs
