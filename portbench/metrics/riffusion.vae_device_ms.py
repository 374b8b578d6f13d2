"""The VAE of a dispatch: the mean ms of the encode (``ldm.encode``: the
content's latent mean and its noising) plus that of the decode
(``ldm.decode``), each its CUDA event interval on the stream, from the
program's own spans."""
from portbench.program import device_ms


def read(ctx):
    enc, dec = device_ms(ctx, "ldm.encode"), device_ms(ctx, "ldm.decode")
    if enc is None or dec is None:
        return None
    return enc + dec
