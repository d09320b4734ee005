"""Batch iteration with shuffling, a static batch shape and host->device
prefetch (counterpart: seld_tpu/data/sampler.py).

A thread stages the next batch on the host while the device computes the
current one. Every batch has the full batch size: the tail of an epoch is
padded by repeating its indices, and `n_valid` says how many rows are
real, so that losses and metrics stay exact.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from seld_tpu_torch.data.corpus import WindowedCorpus


@dataclass
class Batch:
    mel: np.ndarray  # (B, T, C, F) float32
    label_mask: np.ndarray  # (B, T, G) uint16
    n_valid: int  # rows [0, n_valid) are real; the rest are padding
    accdoa: np.ndarray | None = None  # (B, T, ...) float32 when the corpus has them


class BatchIterator:
    """Epoch iterator over corpus windows. shuffle=True reshuffles the
    indices every epoch from default_rng((seed, epoch))."""

    def __init__(self, corpus: WindowedCorpus, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2):
        self.corpus = corpus
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def __len__(self) -> int:
        return -(-len(self.corpus) // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.corpus))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return idx

    def _make_batch(self, idxs: np.ndarray) -> Batch:
        n_valid = len(idxs)
        if n_valid < self.batch_size:  # pad the tail batch to the static shape
            idxs = np.resize(idxs, self.batch_size)
        mel, mask = self.corpus.gather(idxs)
        accdoa = self.corpus.gather_accdoa(idxs) if self.corpus.accdoa is not None else None
        return Batch(mel=mel, label_mask=mask, n_valid=n_valid, accdoa=accdoa)

    def __iter__(self):
        order = self._epoch_indices()
        self.epoch += 1
        chunks = [order[b * self.batch_size:(b + 1) * self.batch_size]
                  for b in range(len(self))]
        if self.prefetch <= 0:
            for idxs in chunks:
                yield self._make_batch(idxs)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for idxs in chunks:
                    q.put(self._make_batch(idxs))
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while (item := q.get()) is not sentinel:
            yield item
        thread.join()


def place_batch(batch: Batch, device: torch.device):
    """Batch -> (mel float32, label_mask int16, example_mask float32) on
    `device`, and the float32 ACCDOA targets fourth when the batch has them.

    The uint16 masks are reinterpreted as int16 here, once: the same two
    bytes per cell go up, at most 13 bits are set, and torch shifts and
    compares int16 where it does not take uint16. On CUDA the arrays go
    through pinned host memory and are copied with non_blocking=True, so
    that placing ahead (`device_prefetch`) overlaps the upload with the
    step that is running."""
    em = (np.arange(batch.mel.shape[0]) < batch.n_valid).astype(np.float32)
    arrays = (batch.mel, batch.label_mask.view(np.int16), em)
    if batch.accdoa is not None:
        arrays += (batch.accdoa.astype(np.float32, copy=False),)
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if device.type == "cuda":
        return tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
    return tuple(t.to(device) for t in tensors)


def device_prefetch(iterable, place, depth: int = 2):
    """Yield `place(item)` for each item, keeping `depth` items placed
    ahead of consumption, in order. depth <= 0 places inline."""
    q: deque = deque()
    for item in iterable:
        q.append(place(item))
        if len(q) > max(depth, 0):
            yield q.popleft()
    while q:
        yield q.popleft()
