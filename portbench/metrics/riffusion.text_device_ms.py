"""The text encoder of a dispatch (``riffusion.text``: the batch's
prompts through CLIP's text tower), mean ms of its CUDA event interval on
the stream, from the program's own spans."""
from portbench.program import device_ms


def read(ctx):
    return device_ms(ctx, "riffusion.text")
