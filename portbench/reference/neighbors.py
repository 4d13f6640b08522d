"""Plain neighbour lists of the reference (numpy, float64).

Semantics of the benchmarked models: edges point src -> dst; a periodic
structure sees the 27 first-shell images (shift vectors in numpy's meshgrid
order, each image's offset ``sa a + sb b + sc c`` summed in that order), the
central image without self-loops (distance above 1e-6); each dst keeps its
``max_neighbors`` closest sources, ties to the first enumerated (image, then
src, then dst).  Returns the kept edges in enumeration order.
"""

from __future__ import annotations

import numpy as np

__all__ = ["neighbor_list", "edge_key"]


def neighbor_list(pos: np.ndarray, cell: np.ndarray, cutoff: float, max_neighbors: int):
    """(src [E], dst [E], shift [E, 3] int) of one periodic structure."""
    pos = np.asarray(pos, np.float64)
    cell = np.asarray(cell, np.float64)
    srcs, dsts, shifts, dists = [], [], [], []
    for sa in (-1, 0, 1):
        for sb in (-1, 0, 1):
            for sc in (-1, 0, 1):
                off = sa * cell[0] + sb * cell[1] + sc * cell[2]
                d = (pos[None, :, :] + off) - pos[:, None, :]        # [src, dst, 3]
                dist = np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                               + d[..., 2] * d[..., 2])
                ok = dist < cutoff
                if sa == sb == sc == 0:
                    ok &= dist > 1e-6
                i, j = np.nonzero(ok)
                srcs.append(i)
                dsts.append(j)
                shifts.append(np.tile([sa, sb, sc], (i.size, 1)))
                dists.append(dist[i, j])
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    shift, dist = np.concatenate(shifts).astype(np.int64), np.concatenate(dists)
    order = np.lexsort((dist, dst))                 # stable: by dst, then distance
    rank = np.empty(order.size, np.int64)
    d_sorted = dst[order]
    start = np.r_[0, np.flatnonzero(d_sorted[1:] != d_sorted[:-1]) + 1]
    counts = np.diff(np.r_[start, order.size])
    rank_sorted = np.arange(order.size) - np.repeat(start, counts)
    rank[order] = rank_sorted
    keep = rank < max_neighbors
    return src[keep], dst[keep], shift[keep]


def edge_key(src, dst, shift) -> np.ndarray:
    """The edges as sorted rows (dst, src, shift) for an exact comparison."""
    rows = np.column_stack([np.asarray(dst), np.asarray(src), np.asarray(shift)]).astype(np.int64)
    return rows[np.lexsort(rows.T[::-1])]
