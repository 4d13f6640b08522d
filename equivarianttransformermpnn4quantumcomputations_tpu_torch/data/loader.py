"""Padded batch loader with background prefetch.

The port's own copy of the JAX package's data/loader.py
(``infer_pad_sizes``, ``PaddedLoader``) for the fixed-degree layout: every
batch has the same (n_pad, e_pad), and a daemon thread builds the next
batches (the neighbour search) while the device computes.  In a
multi-process run each rank iterates its strided shard of the shuffled
order (``num_shards`` / ``shard_id``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from .graph import PaddedBatch, collate

__all__ = ["PaddedLoader", "infer_pad_sizes"]

PAD_SAMPLE, PAD_SAFETY = 512, 1.25


def infer_pad_sizes(dataset, max_neighbors: int | None,
                    batch_size: int) -> tuple[int, int]:
    """Fixed-degree (n_pad, e_pad) from a sample of the dataset.

    Every graph gets ``n_slot`` node rows (the largest of ``PAD_SAMPLE``
    sampled graphs times ``PAD_SAFETY``, rounded up to 4) and every node
    ``max_neighbors`` edge slots, as the JAX package's
    ``infer_pad_sizes(fixed_degree=True)`` at its defaults.
    """
    if max_neighbors is None:
        raise ValueError("fixed-degree pad sizing needs max_neighbors")
    rng = np.random.default_rng(0)
    idx = rng.choice(len(dataset), size=min(PAD_SAMPLE, len(dataset)), replace=False)
    n_max = max([1] + [dataset[int(i)].pos.shape[0] for i in idx])
    n_slot = int(np.ceil(n_max * PAD_SAFETY / 4)) * 4
    return batch_size * n_slot, batch_size * n_slot * max_neighbors


class PaddedLoader:
    """Iterate a dataset as fixed-degree PaddedBatches of one static shape.

    Args:
        dataset: indexable of GraphSample.
        indices: the subset of the dataset to iterate (None: all of it),
            e.g. one part of ``data/qm9.py:qm9_random_split``.
        shuffle: a numpy shuffle seeded by ``seed + epoch`` (``set_epoch``).
        prefetch: number of batches built ahead on a daemon thread (0: none).
        num_shards, shard_id: iterate the strided shard ``shard_id`` of
            ``num_shards`` of the shuffled order, which every rank draws
            from the same seed (DistributedSampler's semantics, reference
            train_oc20v2_parallel.py:334-349; ``parallel/multihost.py:
            host_shard``).

    The ragged tail is dropped, so the batch size stays static.
    ``overflow_atoms / overflow_edges / overflow_batches`` count, per epoch,
    what collate dropped because the pads were too small.
    """

    def __init__(self, dataset, batch_size: int, cutoff: float,
                 max_neighbors: int | None, n_pad: int, e_pad: int,
                 indices: Sequence[int] | None = None, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2, num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(dataset)))
        self.batch_size = batch_size
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.n_pad, self.e_pad = n_pad, e_pad
        self.shuffle, self.seed = shuffle, seed
        self.prefetch = prefetch
        self.num_shards, self.shard_id = num_shards, shard_id
        self.epoch = 0
        self.overflow_atoms = 0
        self.overflow_edges = 0
        self.overflow_batches = 0

    def __len__(self):
        return len(range(self.shard_id, len(self.indices), self.num_shards)) // self.batch_size

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_batches(self):
        idx = self.indices.copy()
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        idx = idx[self.shard_id::self.num_shards]
        for b in range(len(self)):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def _build(self, batch_idx) -> PaddedBatch:
        samples = [self.dataset[int(i)] for i in batch_idx]
        pb = collate(samples, self.cutoff, self.max_neighbors, self.n_pad, self.e_pad)
        if pb.overflow_atoms or pb.overflow_edges:
            self.overflow_atoms += pb.overflow_atoms
            self.overflow_edges += pb.overflow_edges
            self.overflow_batches += 1
        return pb

    def __iter__(self) -> Iterator[PaddedBatch]:
        self.overflow_atoms = self.overflow_edges = self.overflow_batches = 0
        if self.prefetch <= 0:
            for bi in self._index_batches():
                yield self._build(bi)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def worker():
            # an exception is handed to the consumer, which re-raises it
            try:
                for bi in self._index_batches():
                    q.put(self._build(bi))
            except Exception as e:  # noqa: BLE001 - re-raised by the consumer
                q.put(e)
            finally:
                q.put(stop)

        threading.Thread(target=worker, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item
