"""Masked segment reductions and gathers for padded graphs.

Port of the JAX package's ops/segment.py and ops/pallas/segsum.py (which
holds no Pallas kernel: it is XLA custom_vjps around one-hot products, a
TPU workaround for its serialized scatter).  The JAX names and signatures:
``segment_sum``, ``segment_mean``, ``segment_softmax`` and ``gather_nodes``
take the batch layout as ``blocks`` (``models/backbone.py``):

* None: the ragged layout (``data/graph.py:collate`` at its defaults);
* ``(B, n_max, e_max)``: graph-uniform blocks (``collate(uniform=True)``);
* ``(B, n_max, e_max, k)``: the fixed-degree layout
  (``collate(fixed_degree=True)``), where node i owns the k edge slots
  [i k, (i+1) k) and edge slot e points at node e // k.

With ``fixed_dst=True`` (``canonical_dst=True`` for the gather) and a
fixed-degree ``blocks``, a reduction onto the edges' target nodes is an
[N, k, ...] sum over the slots and the target gather is a broadcast (the
slot functions below).  Every other call runs the one ragged
implementation, which also serves the uniform layout: the JAX package's
one-hot matmul, sorted-scan and block-dense paths are TPU routes to the same
function and are not ported as paths of their own.

The ragged gather and sum are a pair of autograd functions, each the
other's transpose, to any derivative order (JAX ops/pallas/segsum.py:
114-140).  The sum adds in a fixed order: on a CUDA tensor through
``index_put_(accumulate=True)``, which sorts the ids and adds each
segment's rows in order (in float32 for bfloat16 rows), never with
atomics, so a step gives the same bits every run; on a CPU tensor through
``index_add_``, which adds the rows one after another.  Neither syncs with
the host.

Padded entries (mask False) contribute exact zeros; a node with no real
edge gets zeros, never NaN.  Softmax statistics are in float32, the
segment max is detached (JAX's ``stop_gradient``), masked logits are
clamped to -1e30, the denominator is at least 1e-16 and a mean's count at
least 1.

Sequence parallelism (parallel/sharding.py) splits the padded edge axis
evenly: rank r of M takes edges [r E/M, (r+1) E/M) and node rows
[r N/M, (r+1) N/M).  The reductions and the target gather take that
rank's ``shard`` (``parallel/sharding.py:EdgeShard``), and their result
holds the complete values of the rank's node rows.  In the fixed-degree
layout a rank's edges are all the slots of its rows, so the slot functions
run unchanged on them, and the target gather reads the rank's rows.  In
the ragged and uniform layouts a node's incoming edges may lie on two
ranks, and padded edges sit at the batch's end (ragged) or at each graph
block's end (uniform), so the last rank holds most of them; nothing relies
on an order of the edges.  There the sum over the rank's edges gives
partial sums of every node, completed onto the rank's rows by
``reduce_scatter``; the softmax takes each node's max over the ranks (an
all-reduce MAX, detached) and its denominator as ``copy_to(reduce_from(
partial))``, since each rank divides its own edges by it; the target
gather reads the whole node array.  The callers gather the rows at the
node boundary (``ModelGroup.gather``).  A sum by other ids (onto the
edges' source nodes, the dual stream's) gives each rank's partial sums,
which the caller reduces (``reduce_from``).
"""

from __future__ import annotations

import torch

__all__ = ["gather_nodes", "segment_sum", "segment_mean", "segment_softmax", "gather_dst",
           "sum_over_slots", "mean_over_slots", "softmax_over_slots", "spread_padding"]

_NEG = -1e30


def _masked(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return values
    return values * mask.to(values.dtype).reshape(mask.shape + (1,) * (values.dim() - 1))


def _sum_rows(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    if values.is_cuda:
        return out.index_put_((ids,), values, accumulate=True)
    return out.index_add_(0, ids, values)


class _Gather(torch.autograd.Function):
    """x [N, ...] -> x[ids] [E, ...]; its backward is ``_SegmentSum``."""

    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.n = x.shape[0]
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _SegmentSum.apply(g, ids, ctx.n), None


class _SegmentSum(torch.autograd.Function):
    """values [E, ...] -> [n, ...] summed by ids; its backward is ``_Gather``."""

    @staticmethod
    def forward(ctx, values, ids, n):
        ctx.save_for_backward(ids)
        return _sum_rows(values, ids, n)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return _Gather.apply(g, ids), None, None


def spread_padding(edge_src: torch.Tensor, edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                   node_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ragged layout's ids with each padding edge's two ends moved from
    node 0 (``data/graph.py:collate``) to one padding node, round robin over
    the padding nodes (rows ``[real, N)``; the last node where there is
    none).  ``index_put_(accumulate=True)`` adds each run of equal ids one
    row after another, so a batch's padding edges on node 0 made one run as
    long as the padding (~41,000 rows in a 64-molecule QM9 batch: 61 % of
    the training step's device time on an H100).  Padding edges carry
    masked (zero) values into every sum and take zero gradients, so no real
    node's value changes; both ends on one padding node keep their
    displacement at 0.  No host sync."""
    n = node_mask.shape[0]
    real = node_mask.sum()
    first = torch.clamp(real, max=n - 1)
    ends = first + torch.arange(edge_src.shape[0], device=edge_src.device) % torch.clamp(
        n - real, min=1)
    return (torch.where(edge_mask, edge_src, ends.to(edge_src.dtype)),
            torch.where(edge_mask, edge_dst, ends.to(edge_dst.dtype)))


def _fixed(blocks, E: int, n: int) -> bool:
    return blocks is not None and len(blocks) > 3 and E == n * blocks[3]


def _slots(blocks, shard, fixed_dst: bool, E: int, n: int) -> bool:
    """Whether a reduction onto the targets runs over the fixed-degree slots:
    the rank's under sequence parallelism (``shard``), else the batch's."""
    if shard is not None:
        return shard.fixed
    return fixed_dst and _fixed(blocks, E, n)


def gather_nodes(x: torch.Tensor, ids: torch.Tensor, blocks=None,
                 canonical_dst: bool = False, shard=None) -> torch.Tensor:
    """x [N, ...] -> x[ids] [E, ...].  ``canonical_dst=True`` with a
    fixed-degree ``blocks`` (the caller asserts ``ids`` is the slot pattern
    e -> e // k) is a broadcast over each node's k slots; with a ``shard``
    (sequence parallelism; module doc) over the slots of the rank's rows."""
    if canonical_dst and blocks is not None and len(blocks) > 3:
        return gather_dst(x if shard is None else x[shard.rows], blocks[3])
    return _Gather.apply(x, ids)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                mask: torch.Tensor | None = None, sorted_ids: bool = False, blocks=None,
                fixed_dst: bool = False, shard=None) -> torch.Tensor:
    """Sum ``values`` [E, ...] into ``num_segments`` rows by ``segment_ids``;
    masked entries contribute zero.  ``sorted_ids`` is accepted as in JAX
    (no path needs it).  ``shard``: the values are the rank's edges and the
    ids their targets; returns the complete sums of the rank's node rows
    (module doc)."""
    del sorted_ids
    if _slots(blocks, shard, fixed_dst, values.shape[0], num_segments):
        return sum_over_slots(values, blocks[3], mask)
    out = _SegmentSum.apply(_masked(values, mask), segment_ids, num_segments)
    return out if shard is None else shard.mp.reduce_scatter(out, dim=0)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: torch.Tensor | None = None, blocks=None,
                 fixed_dst: bool = False, shard=None) -> torch.Tensor:
    """Mean over each segment's real entries (zeros for an empty one); the
    count is taken in ``values``' type, as in JAX.  ``shard``: as
    ``segment_sum``'s, the sum and the count both completed."""
    E = values.shape[0]
    if _slots(blocks, shard, fixed_dst, E, num_segments):
        m = values.new_ones(E, dtype=torch.bool) if mask is None else mask
        return mean_over_slots(values, blocks[3], m)
    s = segment_sum(values, segment_ids, num_segments, mask, shard=shard)
    cnt = segment_sum(values.new_ones(E), segment_ids, num_segments, mask, shard=shard)
    cnt = torch.clamp(cnt, min=1.0).reshape((-1,) + (1,) * (values.dim() - 1))
    return s / cnt


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: torch.Tensor | None = None, sorted_ids: bool = False, blocks=None,
                    fixed_dst: bool = False, shard=None) -> torch.Tensor:
    """Softmax of ``logits`` [E, ...] over the leading axis within each
    segment, in float32; masked entries get weight 0.  ``shard``: the
    logits are the rank's edges, each segment's max and denominator are
    taken over every rank's (module doc); the weights are the rank's."""
    del sorted_ids
    if _slots(blocks, shard, fixed_dst, logits.shape[0], num_segments):
        return softmax_over_slots(logits, blocks[3], mask)
    lg = logits.float()
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (lg.dim() - 1))
        lg = torch.where(m, lg, torch.full_like(lg, _NEG))
    idx = segment_ids.reshape((-1,) + (1,) * (lg.dim() - 1)).expand_as(lg)
    seg_max = lg.new_full((num_segments,) + tuple(lg.shape[1:]), _NEG).scatter_reduce_(
        0, idx, lg.detach(), "amax")
    if shard is not None:
        seg_max = shard.mp.max(seg_max)
    ex = torch.exp(lg - seg_max.index_select(0, segment_ids))
    if mask is not None:
        ex = ex * m.to(ex.dtype)
    denom = _SegmentSum.apply(ex, segment_ids, num_segments)
    if shard is not None:
        denom = shard.mp.copy_to(shard.mp.reduce_from(denom))
    out = ex / torch.clamp(_Gather.apply(denom, segment_ids), min=1e-16)
    return out.to(logits.dtype)


# the fixed-degree layout's slot functions


def gather_dst(x: torch.Tensor, k: int) -> torch.Tensor:
    """Each node's features on its k slots: x [N, ...] -> [N k, ...]."""
    N, rest = x.shape[0], tuple(x.shape[1:])
    return x[:, None].expand((N, k) + rest).reshape((N * k,) + rest)


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
