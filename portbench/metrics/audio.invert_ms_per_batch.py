"""mel_to_audio as the engine calls it (NNLS + Griffin-Lim), ended by a
synchronise."""
from portbench.yardstick import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "audio.invert")
