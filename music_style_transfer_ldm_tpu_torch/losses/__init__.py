"""Losses: the compression, diffusion and style losses, the VGGish
feature distance (kernels D and E on the card) and LPIPS."""

from music_style_transfer_ldm_tpu_torch.losses.basic import (  # noqa: F401
    compression_loss, diffusion_loss, gram_matrix, kl_regularization_loss,
    perceptual_loss, style_loss,
)
from music_style_transfer_ldm_tpu_torch.losses.vggish import (  # noqa: F401
    VGGishFeatureLoss, VGGishFeatures, convert_torchvggish_state_dict,
)
from music_style_transfer_ldm_tpu_torch.losses.lpips import (  # noqa: F401
    LPIPS, LPIPSLoss, convert_torch_lpips_state_dict,
)
