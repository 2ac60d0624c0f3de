"""Batching and shuffling for the host-side samplers (counterpart of
``mdfnet_tpu/data/pipeline.py``).

A thread pool decodes items (PFM/JPEG/cam files are IO bound) and batches
are assembled in numpy, in a deterministic order (the role workers play in
the reference, train.py:105-107).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Sequence

import numpy as np


def collate(items: Sequence[Dict]) -> Dict:
    """Stack a list of item dicts into a batch dict (nested one level)."""
    out: Dict = {}
    for key, val in items[0].items():
        if isinstance(val, dict):
            out[key] = {k: np.stack([it[key][k] for it in items]) for k in val}
        elif isinstance(val, np.ndarray):
            out[key] = np.stack([it[key] for it in items])
        else:
            out[key] = [it[key] for it in items]
    return out


class BatchLoader:
    """Iterable over shuffled, batched items with background workers.

    Args:
        dataset: indexable sampler with __len__/__getitem__.
        batch_size: items per batch; incomplete tail batches are dropped when
            drop_last (every training step sees a full batch).
        shuffle: reshuffle indices each epoch.
        num_workers: decoding threads (0 = synchronous).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = (len(idx) // self.batch_size * self.batch_size
                if self.drop_last else len(idx))
        for i in range(0, stop, self.batch_size):
            yield idx[i:i + self.batch_size]

    def __iter__(self) -> Iterator[Dict]:
        if self.num_workers <= 0:
            for batch_idx in self._index_batches():
                yield collate([self.dataset[int(i)] for i in batch_idx])
            return

        batch_queue: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        batches = list(self._index_batches())
        stop_token = object()

        def producer(worker_id: int):
            for bi, batch_idx in enumerate(batches):
                if bi % self.num_workers != worker_id:
                    continue
                items = [self.dataset[int(i)] for i in batch_idx]
                batch_queue.put((bi, collate(items)))
            batch_queue.put((None, stop_token))

        threads = [threading.Thread(target=producer, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()

        # reorder to deterministic batch order
        pending: Dict[int, Dict] = {}
        next_bi, done_workers = 0, 0
        while done_workers < self.num_workers or pending:
            if next_bi in pending:
                yield pending.pop(next_bi)
                next_bi += 1
                continue
            bi, batch = batch_queue.get()
            if batch is stop_token:
                done_workers += 1
                continue
            pending[bi] = batch
        for t in threads:
            t.join()

