"""PyTorch + CUDA port of the latent-diffusion music style-transfer system.

A sibling of the JAX package ``music_style_transfer_ldm_tpu``, which stays
the reference.  Module names mirror the JAX package's; inside, modules
are NCHW ``nn.Module``s, and public functions take the JAX package's NHWC
layout.  Entry points run on the GPU unless the caller passes
``device="cpu"``.  Kernels: ``ops/fused_sampler.py`` (CUDA C++,
``csrc/fused_sampler.cu``), ``ops/ddim_update.py`` (``csrc/ddim_update.cu``),
``ops/fused_mel_image.py`` (``csrc/fused_mel_image.cu``), and for
training ``ops/normalized_mse.py`` and ``ops/fused_trunk.py``.
The user's entry points are ``cli.py`` and ``serving/server.py``.
"""

from music_style_transfer_ldm_tpu_torch.config import Config, default_config  # noqa: F401

__version__ = "0.1.0"
