"""The sampler of a dispatch (``ldm.sample``: the scan loop, or the call
of kernel A), mean ms of its CUDA event interval on the stream, from
the program's own spans."""
from portbench.program import device_ms


def read(ctx):
    return device_ms(ctx, "ldm.sample")
