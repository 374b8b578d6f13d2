"""The work of one served clip (FlopCounterMode over the reference: the
encoders, 49 UNet steps, the decoder and NNLS; FFTs are not counted) x
clips answered in the window / window / the bf16 peak, in percent."""
from portbench.yardstick import mfu_percent


def read(ctx):
    return mfu_percent(ctx, (ctx.get("work") or {}).get("clip_flops"),
                       ctx["completed"])
