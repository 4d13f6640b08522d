"""Host-side graph construction -> padded, static-shape batches (numpy).

The port's own copy of ``equivarianttransformermpnn4quantumcomputations_tpu/
data/graph.py``.  The neighbour search runs in the C++ builder
(``data/native.py``, compiled with g++ at first use) while ``USE_NATIVE`` is
True, as in the JAX package, and in numpy when it is False; both give the
same edges in the same order, and neither falls back on the other.  The
model receives padded arrays plus masks and re-derives displacement vectors
from positions + integer cell shifts, so forces flow by autograd.

Semantics matched to the reference:
* edges point src -> dst; messages aggregate at dst (edge_index[1]);
* per-dst cap: keep the ``max_neighbors`` *closest* sources
  (reference equiformerv2_qm9.py:470-489);
* PBC: all 27 first-shell images, self-interaction excluded only in the
  central image (reference equiformerv2_MatPES_GATAV2.py:296-311).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..utils.trace import span, sync
from .native import neighbor_list_native

__all__ = ["GraphSample", "radius_graph", "radius_graph_pbc", "collate", "PaddedBatch",
           "as_tensors", "USE_NATIVE"]

# the neighbour search: the C++ builder (True) or numpy (False)
USE_NATIVE = True


@dataclass
class GraphSample:
    """One molecule/crystal, host side (numpy)."""

    atomic_numbers: np.ndarray        # [n] int
    pos: np.ndarray                   # [n, 3] float
    cell: np.ndarray | None = None    # [3, 3] float (PBC) or None
    pbc: bool = False
    # labels (optional)
    y: np.ndarray | None = None           # [T] molecular targets (QM9)
    energy: float | None = None           # total or per-atom energy
    forces: np.ndarray | None = None      # [n, 3]
    stress: np.ndarray | None = None      # [6] Voigt
    fixed: np.ndarray | None = None       # [n] bool fixed-atom mask (OC20 tags)


def radius_graph(pos: np.ndarray, cutoff: float, max_neighbors: int | None):
    """Non-PBC neighbor search with per-dst closest-k cap.

    Returns (src, dst, shift[E,3]=0) index arrays, from the C++ builder
    while ``USE_NATIVE`` is True.
    """
    if USE_NATIVE:
        return neighbor_list_native(pos, None, False, cutoff, max_neighbors)
    diff = pos[None, :, :] - pos[:, None, :]       # [i, j] = pos[j] - pos[i]
    dist = np.linalg.norm(diff, axis=-1)
    within = (dist < cutoff) & (dist > 1e-8)
    src, dst = np.nonzero(within)
    if max_neighbors is not None and src.size:
        src, dst = _cap_per_dst(src, dst, dist[src, dst], max_neighbors)
    return src, dst, np.zeros((src.size, 3), dtype=np.int32)


def radius_graph_pbc(
    pos: np.ndarray, cell: np.ndarray, cutoff: float, max_neighbors: int | None
):
    """PBC neighbor search over the 27 first-shell images.

    Returns (src, dst, shift_int) with dvec = pos[dst] + shift_int @ cell - pos[src],
    from the C++ builder while ``USE_NATIVE`` is True.
    """
    if USE_NATIVE:
        return neighbor_list_native(pos, cell, True, cutoff, max_neighbors)
    rng = np.array([-1, 0, 1])
    shifts = np.stack(
        np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1
    ).reshape(-1, 3)                               # [27, 3]
    offsets = shifts.astype(np.float64) @ cell     # [27, 3]

    src_all, dst_all, shift_all, dist_all = [], [], [], []
    for s_int, off in zip(shifts, offsets):
        # [i, j] = (pos[j] + off) - pos[i]
        diff = (pos[None, :, :] + off[None, None, :]) - pos[:, None, :]
        dist = np.linalg.norm(diff, axis=-1)
        if np.all(s_int == 0):
            within = (dist < cutoff) & (dist > 1e-6)
        else:
            within = dist < cutoff
        src, dst = np.nonzero(within)
        if src.size:
            src_all.append(src)
            dst_all.append(dst)
            shift_all.append(np.broadcast_to(s_int, (src.size, 3)))
            dist_all.append(dist[src, dst])
    if not src_all:
        return (
            np.zeros(0, np.int64),
            np.zeros(0, np.int64),
            np.zeros((0, 3), np.int32),
        )
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    shift = np.concatenate(shift_all).astype(np.int32)
    dist = np.concatenate(dist_all)
    if max_neighbors is not None and src.size:
        keep = _cap_per_dst_mask(dst, dist, max_neighbors)
        src, dst, shift = src[keep], dst[keep], shift[keep]
    return src, dst, shift


def _cap_per_dst_mask(dst, dist, k: int) -> np.ndarray:
    """Boolean mask keeping the k closest edges per destination node."""
    order = np.lexsort((dist, dst))   # sort by dst, then distance
    dst_sorted = dst[order]
    # rank within each dst group
    first = np.ones(dst_sorted.size, dtype=bool)
    first[1:] = dst_sorted[1:] != dst_sorted[:-1]
    group_start = np.maximum.accumulate(
        np.where(first, np.arange(dst_sorted.size), 0)
    )
    rank = np.arange(dst_sorted.size) - group_start
    keep_sorted = rank < k
    keep = np.zeros(dst.size, dtype=bool)
    keep[order] = keep_sorted
    return keep


def _cap_per_dst(src, dst, dist, k: int):
    keep = _cap_per_dst_mask(dst, dist, k)
    return src[keep], dst[keep]


_INDEX_KEYS = ("atomic_numbers", "edge_src", "edge_dst", "graph_idx")


def as_tensors(pb: "PaddedBatch", device) -> dict:
    """The batch as torch tensors on ``device``; index arrays as int64."""
    out = {}
    with span("etq.data.h2d"):
        for k, v in pb.asdict().items():
            with sync("h2d"):
                t = torch.as_tensor(v, device=device)
            out[k] = t.long() if k in _INDEX_KEYS else t
    return out


@dataclass
class PaddedBatch:
    """Static-shape padded batch (all numpy; tensors are made at use)."""

    atomic_numbers: np.ndarray   # [N_pad] int32 (0 = padding)
    pos: np.ndarray              # [N_pad, 3] f32
    graph_idx: np.ndarray        # [N_pad] int32
    node_slot: np.ndarray        # [N_pad] int32: index within its graph
                                 # (out-of-range sentinel for padding)
    node_mask: np.ndarray        # [N_pad] bool
    natoms: np.ndarray           # [B] int32
    edge_src: np.ndarray         # [E_pad] int32
    edge_dst: np.ndarray         # [E_pad] int32
    edge_shift: np.ndarray       # [E_pad, 3] int32
    edge_mask: np.ndarray        # [E_pad] bool
    cell: np.ndarray             # [B, 3, 3] f32 (identity when non-PBC)
    y: np.ndarray | None = None          # [B, T]
    energy: np.ndarray | None = None     # [B]
    forces: np.ndarray | None = None     # [N_pad, 3]
    stress: np.ndarray | None = None     # [B, 6]
    fixed: np.ndarray | None = None      # [N_pad] bool (OC20 fixed atoms;
                                         # host only: no loss reads it yet)
    # atoms/edges dropped because the static pads were too small (host-side
    # ints, never shipped to the device); non-zero means wrong physics
    overflow_atoms: int = 0
    overflow_edges: int = 0

    def asdict(self):
        d = {
            "atomic_numbers": self.atomic_numbers,
            "pos": self.pos,
            "graph_idx": self.graph_idx,
            "node_slot": self.node_slot,
            "node_mask": self.node_mask,
            "natoms": self.natoms,
            "edge_src": self.edge_src,
            "edge_dst": self.edge_dst,
            "edge_shift": self.edge_shift,
            "edge_mask": self.edge_mask,
            "cell": self.cell,
        }
        for k in ("y", "energy", "forces", "stress"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d


def collate(
    samples: Sequence[GraphSample],
    cutoff: float,
    max_neighbors: int | None,
    n_pad: int,
    e_pad: int,
    uniform: bool = False,
    fixed_degree: bool = False,
) -> PaddedBatch:
    """Build graphs per sample and pack them into one padded batch.

    The default is the ragged layout: the graphs' nodes and edges follow
    one another from row 0, padding nodes get atomic number 0 and graph 0,
    and padding edges point 0 -> 0 with mask False.  Within each graph the
    real edges are sorted by destination, so ``edge_dst`` is non-decreasing
    over the real edges.

    ``uniform=True``: graph-uniform blocks.  Every graph gets exactly
    ``n_max = n_pad // B`` node slots and ``e_max = e_pad // B`` edge slots
    (graph b owns rows [b*n_max, (b+1)*n_max) and [b*e_max, (b+1)*e_max));
    padding nodes belong to their own graph and padding edges point at
    their block's first node.

    ``fixed_degree=True`` (implies uniform): every node also owns exactly
    ``k = e_max // n_max`` consecutive edge slots: edge slot ``i*k + j`` is
    the j-th incoming edge of local node i.  Padding slots carry mask False
    with src = dst = their own node, so every dst-keyed segment reduction,
    softmax or gather is a plain [N, k, ...] reshape (ops/segment.py).
    Requires ``k >= max_neighbors``.

    If the batch overflows its pads, edges (then atoms) are truncated; the
    truncation is counted (``PaddedBatch.overflow_atoms/overflow_edges``)
    and warned about, since a truncated graph has wrong physics
    (``data/loader.py:infer_pad_sizes`` sizes the pads from the data).
    """
    B = len(samples)
    if fixed_degree:
        uniform = True
    if uniform and (n_pad % B or e_pad % B):
        raise ValueError(f"uniform collate needs n_pad/e_pad divisible by B={B}")
    n_max = n_pad // B if uniform else None
    e_max = e_pad // B if uniform else None
    k_deg = None
    if fixed_degree:
        if e_max % n_max:
            raise ValueError(
                f"fixed_degree needs e_max ({e_max}) divisible by n_max ({n_max})"
            )
        k_deg = e_max // n_max
        if max_neighbors is not None and k_deg < max_neighbors:
            raise ValueError(
                f"fixed_degree slot count k={k_deg} < max_neighbors={max_neighbors}"
            )
    az = np.zeros(n_pad, np.int32)
    pos = np.zeros((n_pad, 3), np.float32)
    gidx = np.zeros(n_pad, np.int32)
    nslot = np.full(n_pad, 2**30, np.int32)  # OOB sentinel for padding
    nmask = np.zeros(n_pad, bool)
    natoms = np.zeros(B, np.int32)
    if uniform:
        # padding nodes/edges belong to their own block
        gidx = np.repeat(np.arange(B, dtype=np.int32), n_max)
        if fixed_degree:
            # every slot's dst is its owning node (canonical pattern
            # e -> e // k), padding included, so dst-keyed reshape-reductions
            # stay in-node
            edst = np.repeat(np.arange(B * n_max, dtype=np.int32), k_deg)
            esrc = edst.copy()
        else:
            esrc = np.repeat(np.arange(B, dtype=np.int32) * n_max, e_max).astype(np.int32)
            edst = esrc.copy()
    else:
        esrc = np.zeros(e_pad, np.int32)
        edst = np.zeros(e_pad, np.int32)
    eshift = np.zeros((e_pad, 3), np.int32)
    emask = np.zeros(e_pad, bool)
    cell = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    # labels, present when the first sample has them (the JAX collate's rule)
    y0 = samples[0]
    y = np.zeros((B,) + np.shape(y0.y), np.float32) if y0.y is not None else None
    energy = np.zeros(B, np.float32) if y0.energy is not None else None
    forces = np.zeros((n_pad, 3), np.float32) if y0.forces is not None else None
    stress = np.zeros((B, 6), np.float32) if y0.stress is not None else None
    fixed = np.zeros(n_pad, bool) if y0.fixed is not None else None

    node_off = 0
    edge_off = 0
    overflow_atoms = 0
    overflow_edges = 0
    for b, s in enumerate(samples):
        if uniform:
            node_off = b * n_max
            edge_off = b * e_max
            n_cap, e_cap = n_max, e_max
        else:
            n_cap = n_pad - node_off
            e_cap = e_pad - edge_off
        n_real = s.pos.shape[0]
        n = min(n_real, n_cap)
        overflow_atoms += n_real - max(n, 0)
        if n <= 0:
            continue
        sl = slice(node_off, node_off + n)
        az[sl] = s.atomic_numbers[:n]
        pos[sl] = s.pos[:n]
        gidx[sl] = b
        nslot[sl] = np.arange(n)
        nmask[sl] = True
        natoms[b] = n
        if s.cell is not None:
            cell[b] = s.cell
        if s.pbc and s.cell is not None:
            src, dst, shift = radius_graph_pbc(
                s.pos[:n].astype(np.float64), s.cell, cutoff, max_neighbors
            )
        else:
            src, dst, shift = radius_graph(
                s.pos[:n].astype(np.float64), cutoff, max_neighbors
            )
        # INVARIANT: edges sorted by dst within each graph; graphs appended
        # in node-offset order, so edge_dst is non-decreasing over the real
        # edges of a ragged batch
        order = np.argsort(dst, kind="stable")
        src, dst, shift = src[order], dst[order], shift[order]
        e = min(src.size, e_cap)
        overflow_edges += src.size - e
        if fixed_degree:
            # slot = dst * k + rank-within-dst (dst-sorted, so rank =
            # index - group start); degree <= k by the max_neighbors cap
            d = dst[:e]
            first = np.ones(e, dtype=bool)
            first[1:] = d[1:] != d[:-1]
            group_start = np.maximum.accumulate(np.where(first, np.arange(e), 0))
            rank = np.arange(e) - group_start
            ok = rank < k_deg          # safety when max_neighbors is None
            overflow_edges += int(e - ok.sum())
            slots = edge_off + d[ok] * k_deg + rank[ok]
            esrc[slots] = src[:e][ok] + node_off
            edst[slots] = d[ok] + node_off
            eshift[slots] = shift[:e][ok]
            emask[slots] = True
        else:
            esl = slice(edge_off, edge_off + e)
            esrc[esl] = src[:e] + node_off
            edst[esl] = dst[:e] + node_off
            eshift[esl] = shift[:e]
            emask[esl] = True
        if y is not None:
            y[b] = s.y
        if energy is not None:
            energy[b] = s.energy
        if forces is not None:
            forces[sl] = s.forces[:n]
        if stress is not None:
            stress[b] = s.stress
        if fixed is not None:
            fixed[sl] = s.fixed[:n]
        node_off += n
        edge_off += e

    if overflow_atoms or overflow_edges:
        warnings.warn(
            f"collate overflow: dropped {overflow_atoms} atoms / "
            f"{overflow_edges} edges (n_pad={n_pad}, e_pad={e_pad}, B={B}); "
            "the affected graphs' energies and forces are wrong; "
            "increase the pads",
            stacklevel=2,
        )
    return PaddedBatch(
        atomic_numbers=az,
        pos=pos,
        graph_idx=gidx,
        node_slot=nslot,
        node_mask=nmask,
        natoms=natoms,
        edge_src=esrc,
        edge_dst=edst,
        edge_shift=eshift,
        edge_mask=emask,
        cell=cell,
        y=y,
        energy=energy,
        forces=forces,
        stress=stress,
        fixed=fixed,
        overflow_atoms=overflow_atoms,
        overflow_edges=overflow_edges,
    )
