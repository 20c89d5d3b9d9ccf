"""Host-side batching loader with threaded prefetch (counterpart of
frlw_evd_tpu/data/loader.py; reference: data/loader.py).

A thread pool builds the samples of each batch and a producer thread
collates them into a small prefetch queue. The batch order for a seed is
the JAX package's (`np.random.default_rng(seed)` shuffles the indices once
an epoch). With pin_memory the batch's volumes and labels are stacked
straight into page-locked tensors, so the Trainer copies them to the card
with non_blocking=True. The last partial batch is yielded as it is when
drop_last is False, as in the JAX package.

Augmentation draws from the dataset's one `random.Random`: with more than
one worker the draws interleave, so augmented samples match the JAX
package's only with num_workers=1.

With `shard` (rank, world) each batch of batch_size global rows yields
only the rank's contiguous rows of it (parallel/dist.py's rows: equal
shares when `drop_last`, else shares that differ by at most one row); a
batch in which the rank holds no row yields None, so that the ranks'
batches stay aligned.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def collate_batch(samples, pin_memory: bool = False):
    """(imgs (N, H, W, C) f32 tensor, labels (N, G, R) f32 tensor, file
    names, timestamps (N,) numpy) from dataset samples (reference
    collate_events, loader.py:34-47); imgs and labels page-locked when
    pin_memory."""
    imgs = torch.empty((len(samples), *samples[0][0].shape),
                       dtype=torch.float32, pin_memory=pin_memory)
    np.stack([s[0] for s in samples], out=imgs.numpy())
    labels = torch.empty((len(samples), *samples[0][1].shape),
                         dtype=torch.float32, pin_memory=pin_memory)
    labels.numpy()[:] = np.stack([s[1] for s in samples])
    names = [s[2] for s in samples]
    timestamps = np.array([s[3] for s in samples])
    return imgs, labels, names, timestamps


class Loader:
    """Iterates a dataset in batches with background workers."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 4, seed: int = 0, pin_memory: bool = False,
                 shard: tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.rng = np.random.default_rng(seed)
        self.epoch = 0
        self.shard = shard
        rank, world = shard
        if drop_last and batch_size % world:
            raise ValueError(f"a batch of {batch_size} rows does not shard "
                             f"over {world} ranks; make the batch a "
                             f"multiple of the world size")

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        n_full = len(idx) // self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(n_full)]
        rem = idx[n_full * self.batch_size:]
        if len(rem) and not self.drop_last:
            batches.append(rem)
        rank, world = self.shard
        return [b[rank * len(b) // world:(rank + 1) * len(b) // world]
                for b in batches]

    def __iter__(self) -> Iterator:
        batches = self._batch_indices()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        q.put(collate_batch(samples, self.pin_memory)
                              if samples else None)
                q.put(end)
            except BaseException as exc:   # surfaced in the consumer
                q.put(exc)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while t.is_alive():        # unblock a producer waiting on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)
        self.epoch += 1
