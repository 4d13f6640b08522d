"""The tile plan of the edge-rotation engine shared by K1 and K4.

``csrc/edge_rotate.cuh`` runs both rotation kernels on one memory engine:
a persistent grid whose blocks walk tiles of TE edges x CT channels, each
tile's x copied in bulk into a ring of S stages of shared memory beside the
tile's per-edge values.  ``tile_plan`` mirrors the header's ``plan`` (the
libraries export theirs as ``etq_rotate_pairs_plan`` / ``etq_rotate_plan``,
and a test on the card holds the two equal), so the CPU tests can check
that every plan fits the card's shared memory and keeps the bulk copies'
16-byte alignment, and the card's tests can aim at a tile's edges.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["CONSUMERS", "SMEM_LIMIT", "Plan", "tile_plan", "pairs_plan", "rot_plan"]

# csrc/edge_rotate.cuh's constants
CONSUMERS = 128        # consumer threads per block (one producer warp beside them)
MAX_STAGES = 4
BLOCK_SMEM = 115712    # a block's share when two share an SM
SMEM_LIMIT = 232448    # 227 KB: the most one block may take
BAR_BYTES = 128


class Plan(NamedTuple):
    """Edges per tile, channels per tile, stages, and the shared-memory
    layout (byte offsets from the dynamic base)."""
    te: int
    ct: int
    stages: int
    scratch_off: int
    ring_off: int
    x_bytes: int
    stage_bytes: int
    smem: int


def _align128(b: int) -> int:
    return (b + 127) & ~127


def _layout(te, ct, stages, elt, ki, values, scratch, fixed) -> Plan:
    scratch_off = BAR_BYTES + _align128(4 * fixed)
    ring_off = scratch_off + _align128(4 * te * scratch)
    x_bytes = _align128(te * ki * ct * elt)
    stage_bytes = x_bytes + _align128(4 * te * values)
    return Plan(te, ct, stages, scratch_off, ring_off, x_bytes, stage_bytes,
                ring_off + stages * stage_bytes)


def tile_plan(elt: int, C: int, ki: int, values: int, scratch: int = 0, fixed: int = 0) -> Plan:
    """The header's ``plan`` for x [E, ki, C] of ``elt``-byte elements,
    with ``values`` floats per edge in each stage, ``scratch`` floats per
    edge and ``fixed`` floats per block beside the ring."""
    vec = 16 // elt
    groups = C // vec

    def smem(te, ct, s):
        return _layout(te, ct, s, elt, ki, values, scratch, fixed).smem

    g = groups
    while g > 1 and (groups % g or smem(1, g * vec, 2) > SMEM_LIMIT):
        g -= 1
    ct = g * vec
    te = -(-CONSUMERS // g) if ct == C else 1
    while te > 1 and smem(te, ct, 2) > SMEM_LIMIT:
        te -= 1
    budget = BLOCK_SMEM if smem(te, ct, 2) <= BLOCK_SMEM else SMEM_LIMIT
    s = 2
    while s < MAX_STAGES and smem(te, ct, s + 1) <= budget:
        s += 1
    return _layout(te, ct, s, elt, ki, values, scratch, fixed)


def pairs_plan(elt: int, lmax: int, mmax: int, kind: str, C: int) -> Plan:
    """K1's plan: the stage holds v's P floats per edge."""
    from .rotate_dense import _pair_info

    info = _pair_info(lmax, mmax)
    return tile_plan(elt, C, info["n_in"][kind], len(info["pairs"][kind]))


def rot_plan(elt: int, lmax: int, mmax: int, kind: str, C: int) -> Plan:
    """K4's plan: the stage holds the six tables; beside the ring, the
    kind's constants (``kernel_pack``) and per edge the block build's H
    and the block itself."""
    from .rotate import kernel_pack, kernel_segments

    segs = kernel_segments(lmax, mmax, kind)
    ki, ko, km = sum(s[1] for s in segs), sum(s[3] for s in segs), (lmax + 1) ** 2
    scratch = sum((2 * l + 1) * iw + iw * ow for l, (_, iw, _, ow) in enumerate(segs))
    return tile_plan(elt, C, ki, 2 * (ki + km + ko), scratch,
                     kernel_pack(lmax, mmax, kind).size)
