"""95th percentile of submit-to-reply over every request answered in the
window, leaving out those that overlap the profiled sub-window (closing
the profiler holds the engine's thread)."""
from portbench.yardstick import percentile_ms


def read(ctx):
    return percentile_ms(ctx.get("latencies_s", []), 95.0)
