"""Interop: carry the JAX package's flax variables and the reference's
PyTorch weights into the port's modules."""

from music_style_transfer_ldm_tpu_torch.interop.torch_weights import (  # noqa: F401,E501
    convert_autoencoder_state_dicts, convert_decoder_state_dict,
    convert_encoder_state_dict, convert_ldm_state_dict,
    convert_style_encoder_state_dict, convert_unet_state_dict,
)
