"""K1: block-sparse dense-Wigner edge rotation (pairs form) for Hopper.

Port of the JAX package's ops/pallas/rotate_dense.py.  The composite
Wigner-D of an edge is block diagonal with ``P = sum_l r_l (2l+1)`` nonzero
entries (115 at lmax 4 / mmax 2).  It is built once per forward
(``compute_wigner_dense``) and applied by every rotate as

    y[e, ko, :] = sum_p v[e, p] * x[e, ki_p, :]      (pairs p with out-row ko)

The hand-written kernel is ``csrc/rotate_dense.cu`` (replaces the Pallas
``_pairs_kernel`` / ``_call_pairs``; its memory engine, shared with K4, is
``csrc/edge_rotate.cuh``); ``pairs_apply_plain`` is the plain PyTorch
version of the same function.  ``pairs_apply`` launches the kernel for
CUDA tensors and runs the plain version for CPU tensors; nothing falls back.

Differentiation: the operator is linear, and the adjoint of "to" is "from"
on the transposed pair list with the same values (likewise "to_m0" and
"from_m0"), so ``_ToEdge`` and ``_FromEdge`` are each other's backward, to
any order, with no saved activations.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ...utils.trace import sync
from ..irreps import layout as get_layout
from ..rotation import _m_keep_rows, compute_wigner_blocks

__all__ = [
    "INSTANCES",
    "WignerDense",
    "compute_wigner_dense",
    "pairs_apply",
    "pairs_apply_plain",
    "rotate_to_edge_dense",
    "rotate_from_edge_dense",
    "rotate_to_edge_m0_dense",
    "launches",
    "launches_by_lm",
]

KINDS = ("to", "from", "to_m0", "from_m0")
# the (lmax, mmax) pairs of csrc/rotate_dense.cu's ETQ_PAIRS_INSTANCES
INSTANCES = ((1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3), (4, 2), (4, 4), (6, 2))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per kind, and per (kind, lmax, mmax) instance (the launch
# wrapper adds one to each per launch)
launches = {k: 0 for k in KINDS}
launches_by_lm: dict[tuple[str, int, int], int] = collections.defaultdict(int)


# ── static pair tables ─────────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _pair_info(lmax: int, mmax: int) -> dict:
    """Static (ko, ki) pair lists of the block-diagonal truncated Wigner-D.

    ``pairs_to``: rows in the reduced layout, columns in the full layout,
    l-major and row-major within each block (the order compute_wigner_dense
    packs values in).  ``pairs_from`` is the transposed list re-sorted by
    (full row, reduced column), with ``pairs_from[q] = pairs_to[sigma[q]]``
    transposed; the m0 lists restrict the rows to m = 0.
    """
    lay = get_layout(lmax, mmax)
    pairs_to = []
    off_red = 0
    for l in range(lmax + 1):
        rows = _m_keep_rows(l, mmax) if mmax < l else np.arange(2 * l + 1)
        for _ in rows:
            for c in range(2 * l + 1):
                pairs_to.append((off_red, l * l + c))
            off_red += 1
    pairs_to = np.asarray(pairs_to, dtype=np.int64)

    trans = pairs_to[:, ::-1]
    order = np.lexsort((trans[:, 1], trans[:, 0]))
    pairs_from = trans[order]

    m0_rows = np.nonzero(np.asarray(lay.m_complex) == 0)[0]
    m0_rank = {int(r): i for i, r in enumerate(m0_rows)}
    m0_cols = np.asarray(
        [p for p, (ko, _) in enumerate(pairs_to) if int(ko) in m0_rank],
        dtype=np.int64,
    )
    pairs_to_m0 = np.asarray(
        [(m0_rank[int(ko)], ki) for ko, ki in pairs_to if int(ko) in m0_rank],
        dtype=np.int64,
    )
    trans0 = pairs_to_m0[:, ::-1]
    order0 = np.lexsort((trans0[:, 1], trans0[:, 0]))
    return dict(
        pairs={"to": pairs_to, "from": pairs_from,
               "to_m0": pairs_to_m0, "from_m0": trans0[order0]},
        sigma=order, sigma_m0=order0, m0_cols=m0_cols,
        rescale_full=np.asarray(lay.rescale, dtype=np.float32),
        n_out={"to": lay.num_coefficients, "from": (lmax + 1) ** 2,
               "to_m0": len(m0_rows), "from_m0": (lmax + 1) ** 2},
        n_in={"to": (lmax + 1) ** 2, "from": lay.num_coefficients,
              "to_m0": (lmax + 1) ** 2, "from_m0": len(m0_rows)},
    )


def kernel_pair_order(lmax: int, mmax: int, kind: str) -> np.ndarray:
    """The (ko, ki) order in which ``csrc/rotate_dense.cu`` consumes v[e, :]
    (and K4 its per-edge block).

    Mirrors the unrolled loops of ``csrc/edge_rotate.cuh:apply_item``
    (per degree, each output row a sum over the degree's input rows), so a
    CPU test can hold the kernel's contract (values in ``_pair_info``
    order) without a GPU.
    """
    out = []
    ro = 0
    for l in range(lmax + 1):
        d, w = 2 * l + 1, 2 * min(l, mmax) + 1
        if kind == "to":
            out += [(ro + r, l * l + c) for r in range(w) for c in range(d)]
        elif kind == "from":
            out += [(l * l + i, ro + j) for i in range(d) for j in range(w)]
        elif kind == "to_m0":
            out += [(l, l * l + c) for c in range(d)]
        else:
            out += [(l * l + i, l) for i in range(d)]
        ro += w
    return np.asarray(out, dtype=np.int64)


class WignerDense:
    """Per-edge composite Wigner-D values in pairs form (detached).

    One [E, P_kind] float32 table per direction, built once per forward and
    shared by every rotate: to / from without rescale (adjoints of each
    other), from with the truncation rescale and its adjoint, and the m = 0
    pair.
    """

    def __init__(self, lmax, mmax, v_to, v_from, v_from_res, v_to_res,
                 v_to_m0, v_from_m0):
        self.lmax, self.mmax = int(lmax), int(mmax)
        self.v_to, self.v_from = v_to, v_from
        self.v_from_res, self.v_to_res = v_from_res, v_to_res
        self.v_to_m0, self.v_from_m0 = v_to_m0, v_from_m0


def compute_wigner_dense(lmax: int, mmax: int, edge_vec: torch.Tensor) -> WignerDense:
    """Composite per-edge Wigner-D values from the per-degree blocks."""
    info = _pair_info(lmax, mmax)
    blocks = compute_wigner_blocks(lmax, edge_vec).blocks
    cols = []
    for l in range(lmax + 1):
        D = blocks[l]
        if mmax < l:
            with sync("wigner_index"):   # a host index of a device tensor
                D = D[:, _m_keep_rows(l, mmax), :]
        cols.append(D.reshape(D.shape[0], -1))
    v_to = torch.cat(cols, dim=1).contiguous()
    dev = v_to.device

    def idx(a):
        with sync("wigner_consts"):
            return torch.as_tensor(a, dtype=torch.long, device=dev)

    def scale(a):
        with sync("wigner_consts"):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)[None, :]

    pairs = info["pairs"]
    res = info["rescale_full"]
    v_from = v_to[:, idx(info["sigma"])].contiguous()
    v_from_res = v_from * scale(res[pairs["from"][:, 0]])
    v_to_res = v_to * scale(res[pairs["to"][:, 1]])
    m0 = info["m0_cols"]
    v_to_m0 = v_to[:, idx(m0)].contiguous()
    v_from_m0 = v_to[:, idx(m0[info["sigma_m0"]])].contiguous()
    return WignerDense(lmax, mmax, v_to, v_from, v_from_res, v_to_res,
                       v_to_m0, v_from_m0)


# ── the kernel and its plain version ──────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _plain_index(lmax: int, mmax: int, kind: str, device: str):
    p = _pair_info(lmax, mmax)["pairs"][kind]
    return (torch.as_tensor(p[:, 0], device=device),
            torch.as_tensor(p[:, 1], device=device))


def pairs_apply_plain(x: torch.Tensor, v: torch.Tensor, lmax: int, mmax: int,
                      kind: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [E, Ki, C], v [E, P] -> [E, Ko, C]."""
    n_out = _pair_info(lmax, mmax)["n_out"][kind]
    ko, ki = _plain_index(lmax, mmax, kind, str(x.device))
    acc = torch.promote_types(x.dtype, torch.float32)  # f32 accumulation
    terms = x[:, ki, :].to(acc) * v[:, :, None].to(acc)
    y = torch.zeros(x.shape[0], n_out, x.shape[2], dtype=acc, device=x.device)
    return y.index_add_(1, ko, terms).to(x.dtype)


def pairs_apply_kernel(x: torch.Tensor, v: torch.Tensor, lmax: int, mmax: int,
                       kind: str) -> torch.Tensor:
    """Launch ``csrc/rotate_dense.cu`` on the current stream."""
    from . import build

    info = _pair_info(lmax, mmax)
    E, Ki, C = x.shape
    P = len(info["pairs"][kind])
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rotate pairs kernel takes float32 or bfloat16, not {x.dtype}")
    if v.dtype != torch.float32:
        raise TypeError("Wigner values must be float32")
    if not (x.is_cuda and v.device == x.device):
        raise ValueError("x and v must lie on the same CUDA device")
    if not (x.is_contiguous() and v.is_contiguous()):
        raise ValueError("x and v must be contiguous")
    if Ki != info["n_in"][kind] or tuple(v.shape) != (E, P):
        raise ValueError(
            f"{kind}: x {tuple(x.shape)} / v {tuple(v.shape)} do not fit "
            f"lmax {lmax} mmax {mmax} (Ki {info['n_in'][kind]}, P {P})"
        )
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16:
        raise ValueError(f"channels ({C}) must be a multiple of {vec}, 16-byte aligned")
    y = torch.empty((E, info["n_out"][kind], C), dtype=x.dtype, device=x.device)
    lib = build.library("rotate_dense")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.etq_rotate_pairs(
        _DTYPE_CODE[x.dtype], KINDS.index(kind), lmax, mmax,
        x.data_ptr(), v.data_ptr(), y.data_ptr(), E, C, stream,
    )
    build.check("rotate_dense", rc, f"rotate_pairs.{kind}")
    launches[kind] += 1
    launches_by_lm[(kind, lmax, mmax)] += 1
    return y


def pairs_apply(x: torch.Tensor, v: torch.Tensor, lmax: int, mmax: int,
                kind: str) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return pairs_apply_kernel(x, v, lmax, mmax, kind)
    return pairs_apply_plain(x, v, lmax, mmax, kind)


class _ToEdge(torch.autograd.Function):
    """Global frame -> edge frame ("to" or "to_m0"); backward is _FromEdge."""

    @staticmethod
    def forward(ctx, x, v_self, v_adj, lmax, mmax, m0):
        ctx.save_for_backward(v_self, v_adj)
        ctx.meta = (lmax, mmax, m0)
        return pairs_apply(x, v_self, lmax, mmax, "to_m0" if m0 else "to")

    @staticmethod
    def backward(ctx, g):
        v_self, v_adj = ctx.saved_tensors
        lmax, mmax, m0 = ctx.meta
        dx = _FromEdge.apply(g.contiguous(), v_adj, v_self, lmax, mmax, m0)
        return dx, None, None, None, None, None


class _FromEdge(torch.autograd.Function):
    """Edge frame -> global frame ("from" or "from_m0"); backward is _ToEdge."""

    @staticmethod
    def forward(ctx, x, v_self, v_adj, lmax, mmax, m0):
        ctx.save_for_backward(v_self, v_adj)
        ctx.meta = (lmax, mmax, m0)
        return pairs_apply(x, v_self, lmax, mmax, "from_m0" if m0 else "from")

    @staticmethod
    def backward(ctx, g):
        v_self, v_adj = ctx.saved_tensors
        lmax, mmax, m0 = ctx.meta
        dx = _ToEdge.apply(g.contiguous(), v_adj, v_self, lmax, mmax, m0)
        return dx, None, None, None, None, None


def rotate_to_edge_dense(w: WignerDense, x: torch.Tensor) -> torch.Tensor:
    """[E, K_full, C] -> [E, K_red, C]."""
    return _ToEdge.apply(x.contiguous(), w.v_to, w.v_from, w.lmax, w.mmax, False)


def rotate_from_edge_dense(w: WignerDense, x: torch.Tensor) -> torch.Tensor:
    """[E, K_red, C] -> [E, K_full, C], truncation rescale applied."""
    return _FromEdge.apply(x.contiguous(), w.v_from_res, w.v_to_res, w.lmax,
                           w.mmax, False)


def rotate_to_edge_m0_dense(w: WignerDense, x: torch.Tensor) -> torch.Tensor:
    """[E, K_full, C] -> [E, lmax+1, C]: only the m = 0 output rows."""
    return _ToEdge.apply(x.contiguous(), w.v_to_m0, w.v_from_m0, w.lmax,
                         w.mmax, True)
