"""The model zoo: autoencoder, style encoder, style-attending UNet and
the LDM that composes them (NCHW modules; NHWC at the LDM's API)."""

from music_style_transfer_ldm_tpu_torch.models.autoencoder import (  # noqa: F401
    SpectrogramDecoder, SpectrogramEncoder,
)
from music_style_transfer_ldm_tpu_torch.models.style_encoder import StyleEncoder  # noqa: F401
from music_style_transfer_ldm_tpu_torch.models.unet import UNet  # noqa: F401
from music_style_transfer_ldm_tpu_torch.models.layers import (  # noqa: F401
    CrossAttention, SinusoidalPositionEmbeddings,
)
from music_style_transfer_ldm_tpu_torch.models.ldm import LDM  # noqa: F401
