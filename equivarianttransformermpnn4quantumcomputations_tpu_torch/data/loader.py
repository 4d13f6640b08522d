"""Padded batch loader with background prefetch.

The port's own copy of the JAX package's data/loader.py
(``infer_pad_sizes``, ``PaddedLoader``) in the three layouts of
``graph.py:collate`` (ragged, graph-uniform, fixed-degree): every batch has
the same (n_pad, e_pad), and a daemon thread builds the next
batches (the neighbour search) while the device computes.  In a
multi-process run each rank iterates its strided shard of the shuffled
order (``num_shards`` / ``shard_id``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from ..utils.trace import span
from .graph import PaddedBatch, collate

__all__ = ["PaddedLoader", "infer_pad_sizes", "bucket", "FIXED_DEGREE", "fixed_degree_pads"]

# the model fields of the fixed-degree layout (``collate(fixed_degree=True)``)
FIXED_DEGREE = dict(uniform_blocks=True, fixed_degree=True)


def bucket(n: int, quantum: int = 16) -> int:
    """``n`` rounded up to a multiple of ``quantum`` (at least one): the
    serving request's pads (JAX inference.py ``_bucket``)."""
    return max(quantum, -(-n // quantum) * quantum)


def fixed_degree_pads(n_atoms, k: int) -> tuple[int, int]:
    """(n_pad, e_pad) of a fixed-degree batch of graphs of ``n_atoms`` atoms:
    the ragged request's node bucket, raised to a multiple of the graph
    count that holds the largest graph, and ``k`` edge slots per node."""
    B = len(n_atoms)
    n_max = max(-(-bucket(sum(n_atoms) + 1) // B), max(n_atoms))
    return B * n_max, B * n_max * k


def infer_pad_sizes(dataset, cutoff: float, max_neighbors: int | None, batch_size: int,
                    sample: int = 512, safety: float = 1.25, uniform: bool = False,
                    fixed_degree: bool = False) -> tuple[int, int]:
    """(n_pad, e_pad) from a sample of ``sample`` graphs of the dataset.

    Ragged (the default): ``batch_size`` times the largest sampled graph's
    atoms and edges, times ``safety``, rounded up to 8 and 128.
    ``uniform=True``: per-graph slots (atoms rounded up to 4, edges to 32),
    times ``batch_size``.  ``fixed_degree=True``: the uniform node slots and
    ``max_neighbors`` edge slots per node (``collate``'s layouts).
    """
    from .graph import radius_graph, radius_graph_pbc

    rng = np.random.default_rng(0)
    idx = rng.choice(len(dataset), size=min(sample, len(dataset)), replace=False)
    n_max, e_max = 1, 1
    for i in idx:
        s = dataset[int(i)]
        n_max = max(n_max, s.pos.shape[0])
        if fixed_degree:   # the node count alone sizes the fixed-degree pads
            continue
        if s.pbc and s.cell is not None:
            src, _, _ = radius_graph_pbc(s.pos.astype(np.float64), s.cell, cutoff,
                                         max_neighbors)
        else:
            src, _, _ = radius_graph(s.pos.astype(np.float64), cutoff, max_neighbors)
        e_max = max(e_max, src.size)
    if fixed_degree:
        if max_neighbors is None:
            raise ValueError("fixed_degree pad sizing needs max_neighbors")
        n_slot = int(np.ceil(n_max * safety / 4)) * 4
        return batch_size * n_slot, batch_size * n_slot * max_neighbors
    if uniform:
        n_slot = int(np.ceil(n_max * safety / 4)) * 4
        e_slot = int(np.ceil(e_max * safety / 32)) * 32
        return batch_size * n_slot, batch_size * e_slot
    n_pad = int(np.ceil(batch_size * n_max * safety / 8)) * 8
    e_pad = int(np.ceil(batch_size * e_max * safety / 128)) * 128
    return n_pad, e_pad


class PaddedLoader:
    """Iterate a dataset as PaddedBatches of one static shape, in the layout
    ``uniform`` / ``fixed_degree`` select (``graph.py:collate``).

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
                 seed: int = 0, prefetch: int = 2, uniform: bool = False,
                 fixed_degree: bool = False, num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.indices = (np.asarray(indices) if indices is not None
                        else np.arange(len(dataset)))
        self.batch_size = batch_size
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.n_pad, self.e_pad = n_pad, e_pad
        self.shuffle, self.seed = shuffle, seed
        self.prefetch = prefetch
        self.uniform, self.fixed_degree = uniform, fixed_degree
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
        pb = collate(samples, self.cutoff, self.max_neighbors, self.n_pad, self.e_pad,
                     uniform=self.uniform, fixed_degree=self.fixed_degree)
        if pb.overflow_atoms or pb.overflow_edges:
            self.overflow_atoms += pb.overflow_atoms
            self.overflow_edges += pb.overflow_edges
            self.overflow_batches += 1
        return pb

    def __iter__(self) -> Iterator[PaddedBatch]:
        self.overflow_atoms = self.overflow_edges = self.overflow_batches = 0
        if self.prefetch <= 0:
            for bi in self._index_batches():
                with span("etq.data.wait"):
                    pb = self._build(bi)
                yield pb
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
            with span("etq.data.wait"):
                item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            yield item
