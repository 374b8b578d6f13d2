"""Device-resident dataset: the whole spectrogram pack lives on the card.

When the corpus fits the card's memory (the reference recipe's 2,400
images of 128 x 128 are 39.3 MB as uint8), the images are copied to the
card once, as uint8 [n, crop, crop, 1].  Each batch is then one
``index_select`` per side on the card, and only the batch's index vector
crosses from the host.  The trainers normalise uint8 on the card
(``training/state.py as_unit_images``).

Yields the same ``((content, labels), (style, labels))`` batches as
``BatchLoader`` and ``PackedBatchLoader``, so it is a drop-in
``train_epoch`` input.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from music_style_transfer_ldm_tpu_torch.datasets.loader import EpochBatches
from music_style_transfer_ldm_tpu_torch.datasets.packed import (
    PackedPairDataset,
)
from music_style_transfer_ldm_tpu_torch.utils.chips import resolve_device


class DeviceResidentPairs:
    """Paired (content, style) batches gathered on the card, from a pack
    and the pairings CSV of the folder datasets."""

    def __init__(self, pack_path: str | Path, pairing_file: str | Path,
                 crop: int = 128, device="cuda"):
        self.device = resolve_device(device)
        host = PackedPairDataset(pack_path, pairing_file, crop=crop,
                                 use_native=False)
        all_imgs, _ = host.pack.gather(np.arange(len(host.pack)),
                                       dtype="uint8")
        self.images = torch.from_numpy(all_imgs).to(self.device)
        self.pairs = host.pairs
        content, style = host.item_indices(np.arange(len(host.pairs)))
        # [2, n_pairs]: row 0 the content item of each pair, row 1 its style
        self._items = np.stack([content, style])
        host.pack.close()

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def nbytes(self) -> int:
        """Bytes the images hold on the card."""
        return self.images.numel() * self.images.element_size()

    def gather_pairs(self, indices, dtype: str = "uint8"):
        """Pair indices -> (content, style) tensors on the card, gathered
        there: the stored bytes with dtype 'uint8' (the default), else
        ``dtype`` floats in [0, 1] (x * (1/255), as the JAX package's
        gather)."""
        items = torch.from_numpy(
            self._items[:, np.asarray(indices, np.int64)])
        if self.device.type == "cuda":
            items = items.pin_memory()
        items = items.to(self.device, non_blocking=True)
        content = torch.index_select(self.images, 0, items[0])
        style = torch.index_select(self.images, 0, items[1])
        if dtype != "uint8":
            dt = getattr(torch, dtype)
            scale = torch.tensor(1.0 / 255.0, dtype=dt, device=self.device)
            content = content.to(dt) * scale
            style = style.to(dt) * scale
        return content, style


class DevicePairLoader(EpochBatches):
    """Epoch iterator over DeviceResidentPairs, in ``BatchLoader``'s order
    (``EpochBatches``)."""

    def __init__(self, dataset: DeviceResidentPairs, batch_size: int = 128,
                 indices: Optional[Sequence[int]] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        super().__init__(dataset, batch_size, indices, shuffle, seed,
                         drop_last)

    def __iter__(self):
        for bidx in self._epoch_batches():
            content, style = self.dataset.gather_pairs(bidx)
            rows = [self.dataset.pairs[int(j)] for j in bidx]
            yield ((content, [r[0] for r in rows]),
                   (style, [r[2] for r in rows]))
