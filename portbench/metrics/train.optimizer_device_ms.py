"""The LDM step's optimizer (``train.optimizer``), mean ms of its CUDA event
interval on the stream, from the program's own spans."""
from portbench.program import device_ms


def read(ctx):
    return device_ms(ctx, "train.optimizer")
