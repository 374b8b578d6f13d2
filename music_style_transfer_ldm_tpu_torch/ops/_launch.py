"""What a kernel wrapper needs at launch time, beside its built library.

``stream_handle`` gives the raw handle of PyTorch's current stream.  It
calls ``torch._C._cuda_getCurrentRawStream``, the lookup that PyTorch's
own generated launchers use (``torch._inductor``'s ``get_raw_stream``,
present in CUDA builds of torch 2.x): it builds no ``Stream`` object, so
it costs a fraction of the host time of
``torch.cuda.current_stream(device).cuda_stream``, which matters for
kernels whose launch is host-bound (B and C).  A torch without the
private function gets the public lookup.
"""

from __future__ import annotations

import torch

_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA ``device``."""
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(device).cuda_stream
    return _RAW_STREAM(device.index)
