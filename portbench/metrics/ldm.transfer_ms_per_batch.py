"""The engine's sampler call (fused_content_style_transfer or
transfer_decoded: encode, sample, decode), ended by a synchronise."""
from portbench.yardstick import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "ldm.sampler")
