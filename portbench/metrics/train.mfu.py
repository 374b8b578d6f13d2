"""The work of one step (FlopCounterMode over the reference step:
forward, backward, the no-gradient style term) x steps in the window /
window / the bf16 peak, in percent."""
from portbench.yardstick import mfu_percent


def read(ctx):
    return mfu_percent(ctx, (ctx.get("work") or {}).get("step_flops"),
                       ctx["steps"])
