"""Packed spectrogram dataset ("specpack"): builder and host reader.

A pack is built once from the ETL's PNG tree and read with one gather per
batch instead of one PNG decode per sample.  The reader is
``csrc/specpack.cc`` (mmap and a threaded gather, built with the host C++
compiler at first use by ``ops/_build.py build_host_library``), or, where
that library cannot be built or cannot open the file, numpy over a
memory map; ``PackedSpectrogramDataset.native`` says which one is in use.
The container (SPK1) is the JAX package's, byte for byte.

Usage:
    build_pack("processed_images", "train.spk")
    ds = PackedSpectrogramDataset("train.spk")
    batch, labels = ds.gather(indices)          # [n,128,128,1] f32, [n] i32

    python -m music_style_transfer_ldm_tpu_torch.datasets.packed \\
        --pack processed_images train.spk
"""

from __future__ import annotations

import csv
import ctypes
import functools
import struct
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from music_style_transfer_ldm_tpu_torch.ops._build import build_host_library

_MAGIC = 0x314B5053  # "SPK1"


def build_native() -> Path:
    """Compile csrc/specpack.cc (cached by source hash); raises where it
    cannot."""
    return Path(build_host_library("specpack.cc")["path"])


@functools.cache
def _load_native() -> Optional[ctypes.CDLL]:
    """The native library with its signatures, or None (with the reason
    printed) where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build_native()))
    except (OSError, RuntimeError) as e:
        print(f"specpack: native reader unavailable, numpy reads the pack "
              f"({e})", flush=True)
        return None
    lib.spk_open.restype = ctypes.c_void_p
    lib.spk_open.argtypes = [ctypes.c_char_p]
    lib.spk_close.argtypes = [ctypes.c_void_p]
    for fn in ("spk_n_items", "spk_height", "spk_width", "spk_n_classes"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.spk_class_names.restype = ctypes.c_uint32
    lib.spk_class_names.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint32]
    lib.spk_labels.restype = ctypes.c_int
    lib.spk_labels.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_void_p]
    lib.spk_gather_f32.restype = ctypes.c_int
    lib.spk_gather_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_void_p]
    lib.spk_gather_u8.restype = ctypes.c_int
    lib.spk_gather_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_void_p]
    return lib


def _align8(x: int) -> int:
    return (x + 7) & ~7


def write_pack(path: str | Path, images: np.ndarray, labels: np.ndarray,
               class_names: Sequence[str]) -> None:
    """Serialize [n, h, w] uint8 images + labels into the SPK1 container."""
    images = np.ascontiguousarray(images, np.uint8)
    labels = np.ascontiguousarray(labels, np.uint16)
    n, h, w = images.shape
    name_table = b"".join(
        struct.pack("<H", len(c.encode())) + c.encode() for c in class_names)
    with open(path, "wb") as f:
        f.write(struct.pack("<6I", _MAGIC, n, h, w, len(class_names),
                            len(name_table)))
        f.write(name_table)
        f.write(b"\0" * (_align8(24 + len(name_table))
                         - (24 + len(name_table))))
        f.write(labels.tobytes())
        pos = _align8(24 + len(name_table)) + labels.nbytes
        f.write(b"\0" * (_align8(pos) - pos))
        f.write(images.tobytes())


def build_pack(image_root: str | Path, out_path: str | Path) -> int:
    """Pack a ``<label>/*.png`` tree (the folder datasets' order); returns
    the item count.  PNGs are read by ``utils/png.py``."""
    from music_style_transfer_ldm_tpu_torch.datasets.folder import (
        list_image_folder,
    )
    from music_style_transfer_ldm_tpu_torch.utils.png import read_png_gray
    samples, classes = list_image_folder(image_root)
    if not samples:
        raise ValueError(f"no images under {image_root}")
    first = read_png_gray(Path(samples[0][0]).read_bytes())
    images = np.empty((len(samples), *first.shape), np.uint8)
    labels = np.empty((len(samples),), np.uint16)
    for i, (p, lbl) in enumerate(samples):
        img = read_png_gray(Path(p).read_bytes())
        if img.shape != first.shape:
            raise ValueError(f"{p} is {img.shape}, the pack holds "
                             f"{first.shape}")
        images[i] = img
        labels[i] = lbl
    write_pack(out_path, images, labels, classes)
    return len(samples)


class PackedSpectrogramDataset:
    """Reader over a .spk file, native where the library builds."""

    def __init__(self, path: str | Path, crop: int = 128,
                 use_native: bool = True):
        self.path = Path(path)
        self.crop = crop
        self._lib = _load_native() if use_native else None
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.spk_open(str(self.path).encode())
        if self._handle:
            self.n = int(self._lib.spk_n_items(self._handle))
            self.height = int(self._lib.spk_height(self._handle))
            self.width = int(self._lib.spk_width(self._handle))
            need = self._lib.spk_class_names(self._handle, None, 0)
            buf = ctypes.create_string_buffer(need)
            self._lib.spk_class_names(self._handle, buf, need)
            self.classes = buf.raw[:need].decode().split("\n") if need else []
            self._images = None
            self._labels = None
        else:
            self._open_numpy()
        self.native = bool(self._handle)

    # ---- numpy reader -----------------------------------------------------

    def _open_numpy(self) -> None:
        raw = np.memmap(self.path, dtype=np.uint8, mode="r")
        if len(raw) < 24:
            raise ValueError(f"{self.path} is not a specpack file")
        magic, n, h, w, n_classes, table_bytes = struct.unpack(
            "<6I", raw[:24].tobytes())
        if magic != _MAGIC:
            raise ValueError(f"{self.path} is not a specpack file")
        self.n, self.height, self.width = int(n), int(h), int(w)
        table = raw[24:24 + table_bytes].tobytes()
        names, off = [], 0
        for _ in range(n_classes):
            (ln,) = struct.unpack_from("<H", table, off)
            off += 2
            names.append(table[off:off + ln].decode())
            off += ln
        self.classes = names
        pos = _align8(24 + table_bytes)
        self._labels = raw[pos:pos + 2 * n].view(np.uint16)
        pos = _align8(pos + 2 * n)
        if len(raw) < pos + n * h * w:
            raise ValueError(f"{self.path} is truncated")
        self._images = raw[pos:pos + n * h * w].reshape(n, h, w)

    # ---- API ---------------------------------------------------------------

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int):
        x, y = self.gather(np.asarray([idx], np.int64))
        return x[0], int(y[0])

    def labels(self) -> np.ndarray:
        """Every item's label, int32 [n]."""
        if self._handle:
            out = np.empty((self.n,), np.int32)
            idx = np.arange(self.n, dtype=np.int64)
            self._lib.spk_labels(self._handle,
                                 idx.ctypes.data_as(ctypes.c_void_p), self.n,
                                 out.ctypes.data_as(ctypes.c_void_p))
            return out
        return np.asarray(self._labels, np.int32)

    def gather(self, indices, process_index: int = 0,
               process_count: int = 1,
               dtype: str = "float32") -> tuple[np.ndarray, np.ndarray]:
        """indices -> ([n, crop, crop, 1] images, [n] int32 labels).

        dtype 'float32' gives unit-range floats; 'uint8' the stored bytes
        (a quarter of the host-to-card copy; the trainers normalise on the
        card).  With process_count > 1, ``indices`` is the GLOBAL batch
        and only this process's contiguous slice is gathered
        (``datasets/loader.py process_local_indices``)."""
        if process_count > 1:
            from music_style_transfer_ldm_tpu_torch.datasets.loader import (
                process_local_indices,
            )
            indices = process_local_indices(indices, process_index,
                                            process_count)
        idx = np.ascontiguousarray(indices, np.int64)
        n = len(idx)
        c = self.crop
        if c > self.height or c > self.width:
            raise ValueError(f"crop {c} larger than stored image "
                             f"{self.height}x{self.width}")
        # The channel axis is added with standard strides (expand_dims, not
        # [..., None], whose stride 0 changes the memory layout that a
        # convolution over the batch picks, and so its sums' order).
        if self._handle:
            return self._gather_native(idx, n, c, dtype)
        if n and (idx.min() < 0 or idx.max() >= self.n):
            raise IndexError(f"index out of range for pack of {self.n} "
                             "items")
        imgs = self._images[idx][:, :c, :c]
        labels = self._labels[idx].astype(np.int32)
        if dtype == "uint8":
            return np.expand_dims(np.ascontiguousarray(imgs), -1), labels
        return np.expand_dims(imgs.astype(np.float32) / 255.0, -1), labels

    def _gather_native(self, idx, n, c, dtype):
        labels = np.empty((n,), np.int32)
        ptr = idx.ctypes.data_as(ctypes.c_void_p)
        if dtype == "uint8":
            full = np.empty((n, self.height, self.width), np.uint8)
            rc = self._lib.spk_gather_u8(self._handle, ptr, n,
                                         full.ctypes.data_as(ctypes.c_void_p))
            out = np.ascontiguousarray(full[:, :c, :c])
        else:
            out = np.empty((n, c, c), np.float32)
            rc = self._lib.spk_gather_f32(self._handle, ptr, n, c, c,
                                          out.ctypes.data_as(ctypes.c_void_p))
        if rc == -2:
            raise IndexError(f"index out of range for pack of {self.n} "
                             "items")
        if rc != 0:
            raise ValueError("crop larger than stored image")
        self._lib.spk_labels(self._handle, ptr, n,
                             labels.ctypes.data_as(ctypes.c_void_p))
        return np.expand_dims(out, -1), labels

    def close(self) -> None:
        if self._handle:
            self._lib.spk_close(self._handle)
            self._handle = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class PackedPairDataset:
    """(content, style) pairs over a pack, from the pairings CSV of the
    folder datasets (``label1, idx1, label2, idx2``).  Per-class item
    indices come from the pack's labels in stored order, which is the
    folder datasets' sorted order (``build_pack``), so a CSV made against
    the PNG tree addresses the same images here."""

    def __init__(self, pack_path: str | Path, pairing_file: str | Path,
                 crop: int = 128, use_native: bool = True):
        self.pack = PackedSpectrogramDataset(pack_path, crop=crop,
                                             use_native=use_native)
        labels = self.pack.labels()
        self._class_indices = {
            cls: np.flatnonzero(labels == i).astype(np.int64)
            for i, cls in enumerate(self.pack.classes)}
        self.pairs: list[tuple[str, int, str, int]] = []
        with open(pairing_file, "r") as f:
            for row in csv.reader(f):
                if row:
                    self.pairs.append((row[0], int(row[1]), row[2],
                                       int(row[3])))

    def __len__(self) -> int:
        return len(self.pairs)

    def item_indices(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """Pair indices -> (content item indices, style item indices),
        int64, into the pack."""
        rows = [self.pairs[int(i)] for i in np.asarray(indices)]
        content = [self._class_indices[l1][i1] for l1, i1, _, _ in rows]
        style = [self._class_indices[l2][i2] for _, _, l2, i2 in rows]
        return np.asarray(content, np.int64), np.asarray(style, np.int64)

    def __getitem__(self, index: int):
        label1, _, label2, _ = self.pairs[index]
        (a, b) = self.gather_pairs([index])
        return (a[0], label1), (b[0], label2)

    def gather_pairs(self, indices,
                     dtype: str = "float32") -> tuple[np.ndarray, np.ndarray]:
        """-> (content [n, c, c, 1], style [n, c, c, 1]) in one gather of
        all 2n images; dtype as in ``PackedSpectrogramDataset.gather``."""
        content, style = self.item_indices(indices)
        x, _ = self.pack.gather(np.concatenate([content, style]),
                                dtype=dtype)
        n = len(content)
        return x[:n], x[n:]


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser("specpack")
    p.add_argument("--build", action="store_true",
                   help="compile the native reader")
    p.add_argument("--pack", nargs=2, metavar=("IMAGE_ROOT", "OUT"),
                   help="pack an image tree")
    args = p.parse_args(argv)
    if args.build:
        print(f"native library: {build_native()}")
    if args.pack:
        n = build_pack(args.pack[0], args.pack[1])
        print(f"packed {n} items -> {args.pack[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
