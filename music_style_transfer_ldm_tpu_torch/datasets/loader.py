"""Batch loading on the host, with background assembly.

A thread pool decodes the next batch's PNGs while the card computes the
current step.  One process feeds one card (no multi-host slicing).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def train_test_split(n: int, train_fraction: float = 0.8,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded random index split."""
    perm = np.random.RandomState(seed).permutation(n)
    k = int(train_fraction * n)
    return perm[:k], perm[k:]


class BatchLoader:
    """Minibatches of stacked numpy arrays from an indexable dataset.

    dataset[i] may return an array, an (array, label) tuple, or the pair
    dataset's ((img, label), (img, label)); batches stack the arrays and
    collect labels into lists (integer labels into an int32 array).  The
    order is reshuffled every epoch from ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int = 128,
                 indices: Optional[Sequence[int]] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False,
                 num_threads: int = 8, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.indices = (np.arange(len(dataset)) if indices is None
                        else np.asarray(indices))
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

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
        order = self.indices
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self._epoch).permutation(order)
        self._epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if self.num_threads <= 1:
            for bidx in batches:
                yield self._collate([self.dataset[int(i)] for i in bidx])
            return

        q: Queue = Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for bidx in batches:
                        q.put(self._collate(list(pool.map(
                            lambda i: self.dataset[int(i)], bidx))))
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
