"""Acquisition and the offline dataset ETL."""

from music_style_transfer_ldm_tpu_torch.data.build_dataset import (  # noqa: F401
    build_dataset_df, build_dataset_folder_structure, chunk_audio,
)
from music_style_transfer_ldm_tpu_torch.data.downloader import (  # noqa: F401
    AudioDownloader,
)
