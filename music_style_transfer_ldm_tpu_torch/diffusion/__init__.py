"""Diffusion: the noise schedule, q-sampling, and the DDIM samplers."""

from music_style_transfer_ldm_tpu_torch.diffusion.schedule import (  # noqa: F401
    DiffusionSchedule, linear_beta_schedule,
)
from music_style_transfer_ldm_tpu_torch.diffusion.ddim import (  # noqa: F401
    ddim_sample, generation_time_grid, transfer_time_grid,
)
