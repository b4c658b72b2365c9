"""Dataset compilation and a numpy batch loader.

Own copy of ``monoforce_tpu/utils/data.py``, kept as it is, so that one seed
gives the same batches in the same order as the JAX package's loaders.
``compile_data`` mirrors the reference's seeded per-sequence 90/10 train/val
split (reference: utils.py:124-188, split at :155-161, small_data at
:175-185).  ``NumpyLoader`` is a light shuffling iterator that collates
samples into stacked float32 numpy arrays: the host side stays numpy, and
the trainer moves each batch to the device once per step.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["compile_data", "NumpyLoader", "PrefetchLoader", "ConcatDataset",
           "Subset"]


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self._offsets[k])]


def compile_data(seq_paths, Data, val_fraction: float = 0.1, seed: int = 42,
                 small_data: bool = False, **data_kwargs):
    """Build concatenated train/val datasets from sequence directories.

    Per sequence: a seeded random ``val_fraction`` of samples goes to val,
    the rest to train (matching the reference split semantics).
    ``small_data`` truncates each split to 2 samples for debugging.
    """
    train_parts, val_parts = [], []
    for path in seq_paths:
        train_ds = Data(path, is_train=True, **data_kwargs)
        val_ds = Data(path, is_train=False, **data_kwargs)
        n = len(train_ds)
        rng = np.random.default_rng(seed)
        val_ids = rng.choice(n, max(1, int(n * val_fraction)), replace=False)
        train_ids = np.setdiff1d(np.arange(n), val_ids)
        if small_data:
            train_ids, val_ids = train_ids[:2], val_ids[:2]
        train_parts.append(Subset(train_ds, train_ids))
        val_parts.append(Subset(val_ds, val_ids))
    return ConcatDataset(train_parts), ConcatDataset(val_parts)


class NumpyLoader:
    """Shuffled mini-batch iterator with float32 stacking collate."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            samples = [self.dataset[int(i)] for i in idx]
            yield _collate(samples)


def _collate(samples):
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_collate([s[k] for s in samples])
                           for k in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s, dtype=np.float32) for s in samples])


class PrefetchLoader:
    """Wrap a loader with a background-thread prefetch queue so host-side
    sample decoding (PIL, rasterization) overlaps device compute (the
    DataLoader workers' role in the reference trainer, in one thread).

    The batches and their order are the wrapped loader's.  An exception
    raised while loading reaches the consumer (the JAX package's version
    ends the epoch quietly there), and a consumer that stops early stops
    the thread."""

    def __init__(self, loader, prefetch: int = 2):
        self.loader = loader
        self.prefetch = prefetch

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        end = object()
        stop = threading.Event()

        def worker():
            try:
                for batch in self.loader:
                    if stop.is_set():
                        return
                    q.put((batch, None))
            except Exception as e:  # re-raised by the consumer
                q.put((end, e))
                return
            q.put((end, None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item, err = q.get()
                if item is end:
                    if err is not None:
                        raise err
                    break
                yield item
        finally:
            stop.set()
            while t.is_alive():   # a put may wait on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
