"""The engine's read-back of a dispatch (``engine.readback``: the
``.cpu().numpy()`` of its images and audio), mean host ms, from the
program's own spans."""
from portbench.program import host_ms


def read(ctx):
    return host_ms(ctx, "engine.readback")
