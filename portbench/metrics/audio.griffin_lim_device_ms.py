"""Griffin-Lim of a dispatch (``audio.griffin_lim``), mean ms of its CUDA
event interval on the stream, from the program's own spans."""
from portbench.program import device_ms


def read(ctx):
    return device_ms(ctx, "audio.griffin_lim")
