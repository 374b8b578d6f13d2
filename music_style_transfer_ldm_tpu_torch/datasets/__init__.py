"""Image-folder datasets and host-side batch loading."""

from music_style_transfer_ldm_tpu_torch.datasets.folder import (  # noqa: F401
    SpectrogramDataset, SpectrogramPairDataset, generate_pairings,
    list_image_folder, load_image_unit,
)
from music_style_transfer_ldm_tpu_torch.datasets.loader import (  # noqa: F401
    BatchLoader, prepare_dataset, train_test_split,
)
