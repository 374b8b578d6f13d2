"""Share of the profiled sub-window in which no kernel, copy or set ran
on the device (torch.profiler)."""
from portbench.yardstick import idle_fraction


def read(ctx):
    return idle_fraction(ctx)
