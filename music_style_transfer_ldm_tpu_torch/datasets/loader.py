"""Batch loading on the host, with background assembly.

* ``BatchLoader``: a thread pool decodes the next batch's items (PNGs)
  while the card computes the current step;
* ``PackedBatchLoader``: one gather per batch from a pack
  (``datasets/packed.py``), prefetched on a background thread;
* ``process_local_indices``: each process's contiguous slice of a global
  batch, so that processes that share the seeded order load disjoint
  rows (both loaders take ``process_index`` / ``process_count``);
* ``prepare_dataset``: the autoencoder phase's train and test loaders.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from music_style_transfer_ldm_tpu_torch.datasets.folder import (
    SpectrogramDataset,
)


def process_local_indices(indices, process_index: int,
                          process_count: int) -> np.ndarray:
    """Rows [pi * ceil(n/P) : (pi + 1) * ceil(n/P)] of a global batch's
    index list.  A short batch is padded by repeating its last index, so
    every process gets the same number of rows."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in "
                         f"[0, {process_count})")
    idx = np.asarray(indices)
    n = len(idx)
    per = -(-n // process_count)  # ceil
    short = per * process_count - n
    if short:
        idx = np.concatenate([idx, np.repeat(idx[-1:], short)])
    return idx[process_index * per:(process_index + 1) * per]


def _background(produce, batches, prefetch: int) -> Iterator:
    """Yield ``produce(b)`` for each batch, computed up to ``prefetch``
    ahead on a background thread; its exception is raised here."""
    q: Queue = Queue(maxsize=prefetch)
    stop = object()

    def worker():
        try:
            for bidx in batches:
                q.put(produce(bidx))
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — raised below
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            t.join()
            raise item
        yield item
    t.join()


class EpochBatches:
    """The epoch order that every loader shares: ``indices`` (default:
    every item) reshuffled each epoch from ``seed + epoch`` when
    ``shuffle``, cut into batches of ``batch_size`` (the last one short
    unless ``drop_last``).  ``batch_size`` is the GLOBAL batch: with
    ``process_count`` > 1 every process walks the same order and keeps
    only its slice of each batch (``process_local_indices``)."""

    def __init__(self, dataset, batch_size: int = 128,
                 indices: Optional[Sequence[int]] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = (np.arange(len(dataset)) if indices is None
                        else np.asarray(indices))
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_batches(self) -> list:
        """The index lists of the next epoch (this process's slices)."""
        order = self.indices
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self._epoch).permutation(order)
        self._epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.process_count > 1:
            batches = [process_local_indices(b, self.process_index,
                                             self.process_count)
                       for b in batches]
        return batches


def train_test_split(n: int, train_fraction: float = 0.8,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded random index split."""
    perm = np.random.RandomState(seed).permutation(n)
    k = int(train_fraction * n)
    return perm[:k], perm[k:]


class BatchLoader(EpochBatches):
    """Minibatches of stacked numpy arrays from an indexable dataset, in
    ``EpochBatches``' order, assembled by ``num_threads`` threads up to
    ``prefetch`` batches ahead.

    dataset[i] may return an array, an (array, label) tuple, or the pair
    dataset's ((img, label), (img, label)); batches stack the arrays and
    collect labels into lists (integer labels into an int32 array)."""

    def __init__(self, dataset, batch_size: int = 128,
                 indices: Optional[Sequence[int]] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 num_threads: int = 8, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        super().__init__(dataset, batch_size, indices, shuffle, seed,
                         drop_last, process_index, process_count)
        self.num_threads = num_threads
        self.prefetch = prefetch

    def _collate(self, items):
        first = items[0]
        if isinstance(first, tuple) and isinstance(first[0], tuple):
            return (self._collate([it[0] for it in items]),
                    self._collate([it[1] for it in items]))
        if isinstance(first, tuple):
            arrs = np.stack([it[0] for it in items])
            labels = [it[1] for it in items]
            if all(isinstance(lb, (int, np.integer)) for lb in labels):
                labels = np.asarray(labels, np.int32)
            return arrs, labels
        return np.stack(items)

    def __iter__(self) -> Iterator:
        batches = self._epoch_batches()
        if self.num_threads <= 1:
            for bidx in batches:
                yield self._collate([self.dataset[int(i)] for i in bidx])
            return
        with ThreadPoolExecutor(self.num_threads) as pool:
            yield from _background(
                lambda bidx: self._collate(list(pool.map(
                    lambda i: self.dataset[int(i)], bidx))),
                batches, self.prefetch)


class PackedBatchLoader(EpochBatches):
    """Batches from a gather-capable pack: one gather per batch
    (``PackedSpectrogramDataset.gather`` or, in pair mode,
    ``gather_pairs``) in ``EpochBatches``' order, prefetched on a
    background thread.  Pair mode (the default when the dataset has
    ``gather_pairs``) yields the ``((content, labels), (style, labels))``
    that ``LDMTrainer`` consumes, else ``(images, labels)``.
    ``dtype='uint8'`` yields the stored bytes (the trainers normalise on
    the card)."""

    def __init__(self, dataset, batch_size: int = 128,
                 indices: Optional[Sequence[int]] = None,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 pair: Optional[bool] = None, dtype: str = "float32"):
        super().__init__(dataset, batch_size, indices, shuffle, seed,
                         drop_last, process_index, process_count)
        self.prefetch = prefetch
        self.pair = (hasattr(dataset, "gather_pairs") if pair is None
                     else pair)
        self.dtype = dtype

    def _fetch(self, bidx):
        if self.pair:
            content, style = self.dataset.gather_pairs(bidx,
                                                       dtype=self.dtype)
            rows = [self.dataset.pairs[int(i)] for i in bidx]
            return ((content, [r[0] for r in rows]),
                    (style, [r[2] for r in rows]))
        return self.dataset.gather(bidx, dtype=self.dtype)

    def __iter__(self) -> Iterator:
        return _background(self._fetch, self._epoch_batches(), self.prefetch)


def prepare_dataset(config, root: str | None = None):
    """(train_loader, test_loader) for the autoencoder phase: the images
    under ``root`` (default ``config.data.processed_dir``) split
    ``train_test_split(n, config.train.train_split, config.train.seed)``,
    the train part shuffled every epoch, the test part in order."""
    root = root or config.data.processed_dir
    ds = SpectrogramDataset(root, image_size=config.model.image_size)
    tr_idx, te_idx = train_test_split(len(ds), config.train.train_split,
                                      seed=config.train.seed)
    train_loader = BatchLoader(ds, config.train.batch_size, indices=tr_idx,
                               shuffle=True, seed=config.train.seed)
    test_loader = BatchLoader(ds, config.train.batch_size, indices=te_idx,
                              shuffle=False)
    return train_loader, test_loader
