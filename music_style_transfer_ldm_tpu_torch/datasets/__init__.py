"""The input pipeline: image-folder datasets, packs, the device-resident
corpus, and their batch loaders."""

from music_style_transfer_ldm_tpu_torch.datasets.folder import (  # noqa: F401
    SpectrogramDataset, SpectrogramPairDataset, generate_pairings,
    list_image_folder, load_image_unit,
)
from music_style_transfer_ldm_tpu_torch.datasets.loader import (  # noqa: F401
    BatchLoader, PackedBatchLoader, prepare_dataset, process_local_indices,
    train_test_split,
)
from music_style_transfer_ldm_tpu_torch.datasets.packed import (  # noqa: F401
    PackedPairDataset, PackedSpectrogramDataset, build_pack,
)
from music_style_transfer_ldm_tpu_torch.datasets.device import (  # noqa: F401
    DevicePairLoader, DeviceResidentPairs,
)
