"""The Hopper kernels' wrappers (CUDA C++ under ``csrc/``, built by
``_build.py`` at first launch): ``fused_sampler`` (A), ``ddim_update``
(B), ``fused_mel_image`` (C), ``normalized_mse`` (D) and ``fused_trunk``
(E).  ``fused_mel_unit_image`` and ``fused_ddim_update`` load on first
use: the front end's module imports ``audio``, whose processor imports
it back.  Importing this package builds no kernel."""

from music_style_transfer_ldm_tpu_torch.utils.lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(__name__, {
    "fused_mel_unit_image": "fused_mel_image",
    "fused_ddim_update": "ddim_update"})
