"""Host time per call of InferenceEngine.transfer_batch (ends in the
read-back), outside the profiled sub-window."""
from portbench.yardstick import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "engine.transfer_batch")
