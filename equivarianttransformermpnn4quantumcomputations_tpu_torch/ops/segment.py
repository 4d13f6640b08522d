"""Masked segment reductions and gathers for padded graphs.

Port of the JAX package's ops/segment.py and ops/pallas/segsum.py (which
holds no Pallas kernel: it is XLA custom_vjps around one-hot products, a
TPU workaround for its serialized scatter).  The port batches in the
fixed-degree layout only (``data/graph.py:collate``): node i owns the
k edge slots [i k, (i+1) k), and edge slot e points at node e // k.  So
every reduction onto the edges' target nodes is an [N, k, ...] sum over the
slots, and the target gather is a broadcast.  The source gather and the
per-graph energy sum are ``index_select`` and ``index_add``, whose autograd
transposes are each other.

Padded entries (mask False) contribute exact zeros; a node with no real
edge gets zeros, never NaN.

Sequence parallelism (parallel/sharding.py) splits E = N k contiguously, so
a rank's edges are all the slots of its N/M node rows: the slot reductions
and the slot softmax run unchanged on them and give those rows, which the
callers gather at the node boundary (``ModelGroup.gather``); the target
gather reads the rank's rows (``gather_dst(x[rows], k)``).  A sum by other
ids (``segment_sum`` onto the edges' source nodes, the dual stream's) gives
each rank's partial sums, which the caller reduces (``reduce_from``).
"""

from __future__ import annotations

import torch

__all__ = ["gather_nodes", "gather_dst", "segment_sum", "sum_over_slots",
           "mean_over_slots", "softmax_over_slots"]

_NEG = -1e30


def _masked(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values
    return values * mask.to(values.dtype).reshape(mask.shape + (1,) * (values.dim() - 1))


def gather_nodes(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x [N, ...] -> x[ids] [E, ...]."""
    return x.index_select(0, ids)


def gather_dst(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each node's features on its k slots: x [N, ...] -> [N k, ...]."""
    N, rest = x.shape[0], tuple(x.shape[1:])
    return x[:, None].expand((N, k) + rest).reshape((N * k,) + rest)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum ``values`` [E, ...] into ``num_segments`` rows by ``segment_ids``."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add(0, segment_ids, _masked(values, mask))


def sum_over_slots(values: torch.Tensor, k: int,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum the k slots of each node: values [N k, ...] -> [N, ...]."""
    values = _masked(values, mask)
    return values.reshape((values.shape[0] // k, k) + tuple(values.shape[1:])).sum(1)


def mean_over_slots(values: torch.Tensor, k: int, mask: torch.Tensor) -> torch.Tensor:
    """Mean over each node's real slots (zeros for a node with none):
    values [N k, ...] -> [N, ...]; the count is taken in ``values``' type,
    as the JAX package's ``segment_mean`` does."""
    cnt = mask.to(values.dtype).reshape(-1, k).sum(1)
    cnt = torch.clamp(cnt, min=1.0).reshape((-1,) + (1,) * (values.dim() - 1))
    return sum_over_slots(values, k, mask) / cnt


def softmax_over_slots(logits: torch.Tensor, k: int,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax of ``logits`` [N k, H] over each node's real slots (in f32)."""
    lg = logits.float().reshape(logits.shape[0] // k, k, -1)
    if mask is not None:
        m = mask.reshape(-1, k, 1)
        lg = torch.where(m, lg, torch.full_like(lg, _NEG))
    seg_max = torch.clamp(lg.max(dim=1, keepdim=True).values, min=_NEG).detach()
    ex = torch.exp(lg - seg_max)
    if mask is not None:
        ex = ex * m.to(ex.dtype)
    out = ex / torch.clamp(ex.sum(dim=1, keepdim=True), min=1e-16)
    return out.reshape(logits.shape).to(logits.dtype)
