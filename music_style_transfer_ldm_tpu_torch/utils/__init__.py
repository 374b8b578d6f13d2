"""Utilities: .env loading, device selection and the card's peaks, the
kernel build cache, PNG I/O, profiling."""

from music_style_transfer_ldm_tpu_torch.utils.env import get_env, load_env_file  # noqa: F401
