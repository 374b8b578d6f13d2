"""The sampler of a dispatch (``ldm.sample``), mean host ms: the time to
issue its steps, since nothing in it synchronises; from the program's
own spans."""
from portbench.program import host_ms


def read(ctx):
    return host_ms(ctx, "ldm.sample")
