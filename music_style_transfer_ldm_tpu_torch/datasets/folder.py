"""Spectrogram image-folder datasets.

* ``SpectrogramDataset``: unpaired images under ``<root>/<label>/*.png``,
  labels the sorted folder names (torchvision ImageFolder's indexing);
* ``SpectrogramPairDataset``: (content, style) pairs from a pairings CSV
  of rows ``label1, idx1, label2, idx2``;
* ``generate_pairings``: the deterministic cross-label pairing CSV, the
  same ``RandomState(42)`` draws as the JAX package, so the CSV is the
  same file.

Files are enumerated in sorted ``os.walk`` order within each class
folder, so CSV indices address the same images.  Images are NHWC float32
[128, 128, 1] in [0, 1] (cropped from the top-left, zero-padded when
small), decoded by ``utils/png.py`` (PNG only; no Pillow).
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from music_style_transfer_ldm_tpu_torch.utils.png import read_png_gray

_IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tiff", ".webp")


def image_unit_from_gray(arr: np.ndarray, size: int = 128) -> np.ndarray:
    """uint8 [H, W] -> float32 [size, size, 1] in [0, 1]: crop from the
    top-left, zero-pad an undersized image."""
    arr = np.asarray(arr, np.uint8)[:size, :size]
    if arr.shape != (size, size):
        padded = np.zeros((size, size), np.uint8)
        padded[:arr.shape[0], :arr.shape[1]] = arr
        arr = padded
    return (arr.astype(np.float32) / 255.0)[..., None]


def load_image_unit(path: str | Path, size: int = 128) -> np.ndarray:
    """PNG -> float32 [size, size, 1] in [0, 1]."""
    return image_unit_from_gray(read_png_gray(Path(path).read_bytes()), size)


def _sorted_image_files(directory: Path) -> List[Path]:
    """Image files under ``directory`` in sorted os.walk order."""
    out: List[Path] = []
    for root, _, fnames in sorted(os.walk(directory, followlinks=True)):
        for fname in sorted(fnames):
            if fname.lower().endswith(_IMG_EXTENSIONS):
                out.append(Path(root) / fname)
    return out


def list_image_folder(root: str | Path
                      ) -> Tuple[List[Tuple[Path, int]], List[str]]:
    """(samples, classes): classes are the sorted subfolder names, samples
    (path, class index)."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    samples = [(p, idx) for idx, cls in enumerate(classes)
               for p in _sorted_image_files(root / cls)]
    return samples, classes


class SpectrogramDataset:
    """Unpaired images with integer labels."""

    def __init__(self, root: str | Path, image_size: int = 128):
        self.samples, self.classes = list_image_folder(root)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        path, label = self.samples[idx]
        return load_image_unit(path, self.image_size), label


class ImageFolderNoSubdirs:
    """The images directly inside one label folder."""

    def __init__(self, folder: Path, image_size: int = 128):
        self.files = _sorted_image_files(folder)
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> np.ndarray:
        return load_image_unit(self.files[idx], self.image_size)


class SpectrogramPairDataset:
    """(content, style) pairs from a pairings CSV; ``[i]`` is ((img1,
    label1), (img2, label2)) with string labels."""

    def __init__(self, root_folder: str | Path, pairing_file: str | Path,
                 image_size: int = 128):
        self.root_folder = Path(root_folder)
        self.pairs: List[Tuple[str, int, str, int]] = []
        with open(pairing_file, "r") as f:
            for row in csv.reader(f):
                if row:
                    self.pairs.append((row[0], int(row[1]), row[2],
                                       int(row[3])))
        self.datasets: Dict[str, ImageFolderNoSubdirs] = {}
        for folder in sorted(os.listdir(self.root_folder)):
            fp = self.root_folder / folder
            if fp.is_dir():
                self.datasets[folder] = ImageFolderNoSubdirs(fp, image_size)

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, index: int):
        label1, idx1, label2, idx2 = self.pairs[index]
        return ((self.datasets[label1][idx1], label1),
                (self.datasets[label2][idx2], label2))


def generate_pairings(root_folder: str | Path,
                      output_file_path: str | Path =
                      "spectrogram_pair_dataset_pairings.csv",
                      num_pairs: int = 15000, seed: int = 42) -> None:
    """Deterministic cross-label pairing CSV: per row two distinct labels
    (choice without replacement), then an index into each."""
    root_folder = Path(root_folder)
    labels = sorted(d.name for d in root_folder.iterdir() if d.is_dir())
    if len(labels) < 2:
        raise ValueError("Need at least two classes to form pairs.")
    sizes = {lb: len(_sorted_image_files(root_folder / lb)) for lb in labels}
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(num_pairs):
        label1, label2 = rng.choice(labels, size=2, replace=False)
        idx1 = rng.randint(0, sizes[label1])
        idx2 = rng.randint(0, sizes[label2])
        rows.append((label1, idx1, label2, idx2))
    with open(output_file_path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
