"""NNLS of a dispatch's mel images (``audio.nnls``), mean ms of its CUDA
event interval on the stream, from the program's own spans."""
from portbench.program import device_ms


def read(ctx):
    return device_ms(ctx, "audio.nnls")
