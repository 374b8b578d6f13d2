"""Host time to draw one batch from the cell's loader."""
from portbench.yardstick import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "data.next_batch")
