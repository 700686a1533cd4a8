"""DataLoader: a threaded batch loader (a copy of the JAX package's
``core/dataset/loader.py``).

The per-item host work is a file read, a decode and at most one resize
(the augmentation runs on the device), so a thread pool does it: the
decoders release the GIL, and threads need no process start or pickling.
One batch of prefetch overlaps the next batch's loading with the step.
Shuffling is seeded by ``seed`` and the epoch (``set_epoch``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np


class DataLoader:
    def __init__(self,
                 dataset,
                 batch_size: int = 1,
                 shuffle: bool = False,
                 num_workers: int = 4,
                 collate_fn: Optional[Callable] = None,
                 drop_last: bool = False,
                 seed: int = 0,
                 pin_memory: bool = False):  # accepted for parity; unused
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(int(num_workers), 0)
        self.collate_fn = collate_fn or getattr(dataset, "collate_fn", None) \
            or _default_collate
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        # two executors: items decode on `_pool`, the one-batch prefetch runs
        # on its own thread — _fetch must never run *inside* `_pool` or a
        # single-worker pool deadlocks (the prefetch task would block
        # waiting for item tasks that can't start)
        self._pool = (ThreadPoolExecutor(max_workers=self.num_workers)
                      if self.num_workers > 0 else None)
        self._prefetcher = (ThreadPoolExecutor(max_workers=1)
                            if self.num_workers > 0 else None)
        if self._pool is not None:
            # idle worker threads would otherwise outlive the loader — a
            # process that builds loaders repeatedly (test suite, repeated
            # val runs) accumulates num_workers+1 threads per instance
            import weakref
            weakref.finalize(self, DataLoader._shutdown_executors,
                             self._pool, self._prefetcher)

    @staticmethod
    def _shutdown_executors(pool, prefetcher):
        for ex in (pool, prefetcher):
            if ex is not None:
                ex.shutdown(wait=False)

    def close(self):
        """Release the worker threads now (also runs at GC via finalizer)."""
        self._shutdown_executors(self._pool, self._prefetcher)
        self._pool = self._prefetcher = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _fetch(self, indices):
        if self._pool is not None:
            items = list(self._pool.map(self.dataset.__getitem__, indices))
        else:
            items = [self.dataset[i] for i in indices]
        return self.collate_fn(items)

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed * 1000003 + self.epoch)
            rng.shuffle(order)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self._pool is None:
            for b in batches:
                yield self._fetch(b)
            return
        # one-batch prefetch: overlap the next fetch with the consumer
        fut = None
        for b in batches:
            if fut is None:
                fut = self._prefetcher.submit(self._fetch, b)
                continue
            current = fut.result()
            fut = self._prefetcher.submit(self._fetch, b)
            yield current
        if fut is not None:
            yield fut.result()


def _default_collate(items):
    images, labels, infos = zip(*items)
    images = np.stack(images)
    labels = np.stack(labels) if labels[0] is not None else None
    merged: dict = {}
    for info in infos:
        for k, v in info.items():
            merged.setdefault(k, []).append(v)
    return images, labels, merged
