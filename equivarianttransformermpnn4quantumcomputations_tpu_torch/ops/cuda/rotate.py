"""K4: fused factored-Wigner edge rotation for Hopper.

Port of the JAX package's ops/pallas/rotate.py.  The factored Wigner-D of an
edge is D = Xz(a) J Xz(b) J Xz(g): three per-edge z-rotations (cos / sin
tables, ``ops/rotation.py:WignerFactors``) and a constant block-diagonal J.
Every direction of the rotate is the same five-factor chain, differing only
in its tables (the JAX package's flip-folded algebra):

    z  = [t1a o x ; t1b o x]       h  = W1 z        (W1 = [J | J P] etc.)
    z2 = [t2a o h ; t2b o h]       uv = W2 z2       (W2 stacks the last J stage
    y  = t3a o uv[:Ko] + t3b o uv[Ko:]               and its flip-permuted rows)

``rot_plain`` is that algebra in PyTorch with the dense W1 / W2.  The
hand-written kernel ``csrc/rotate.cu`` (replaces the Pallas ``_rot_kernel``
/ ``_call_rot``) uses that every factor maps degree l onto degree l: only
the per-degree blocks of W1 and W2 are nonzero, and those constants sit in
the kernel's ``__constant__`` memory, packed per (lmax, mmax, kind) by
``kernel_pack`` (uploaded once per device).  The chain is linear in x, so
the kernel first forms each edge's block-diagonal matrix from the tables
(``block_from_factors_plain`` is that build in PyTorch: the dense Wigner's
values in K1's pair order) and then applies it with K1's loop, on the
memory engine it shares with K1 (``csrc/edge_rotate.cuh``).
``rot`` launches the kernel for CUDA tensors and runs the plain version for
CPU tensors; nothing falls back.

Four kinds, as in K1: "to" (full -> reduced rows), "from" (reduced -> full),
"to_m0" (full -> the m = 0 rows) and "from_m0" (its adjoint).  The operator
is linear and ``to^T = from`` without the truncation rescale (the rescale is
folded into the adjoint's first tables), so ``_RotTo`` and ``_RotFrom`` are
each other's backward, to any order, with no saved activations.  Nothing is
padded: the kernel masks the ragged edge tile.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.trace import sync
from ..irreps import layout as get_layout
from ..rotation import _J_dense, _abs_m_index, _flip_index, _flip_index_reduced, _sign_m

__all__ = [
    "KINDS",
    "ADJOINT",
    "INSTANCES",
    "tables",
    "rot",
    "rot_plain",
    "rot_kernel",
    "block_from_factors_plain",
    "kernel_pack",
    "kernel_segments",
    "rotate",
    "rotate_to_edge_fused",
    "rotate_to_edge_m0_fused",
    "rotate_from_edge_fused",
    "launches",
]

KINDS = ("to", "from", "to_m0", "from_m0")
ADJOINT = {"to": "from", "from": "to", "to_m0": "from_m0", "from_m0": "to_m0"}
# the (lmax, mmax) pairs of csrc/rotate.cu's ETQ_ROT_INSTANCES, in its
# constant order; _upload_consts checks every offset against the library
INSTANCES = ((2, 1), (3, 2), (4, 2), (6, 2))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per kind (the launch wrapper adds one per launch)
launches = {k: 0 for k in KINDS}


# ── constants and tables ───────────────────────────────────────────────────


@functools.lru_cache(maxsize=None)
def _consts(lmax: int, mmax: int) -> dict:
    """Static per-(lmax, mmax) constants of both directions (the JAX
    package's ``_consts``), with the W pair of every kind."""
    lay = get_layout(lmax, mmax)
    J = _J_dense(lmax)
    flip = _flip_index(lmax)
    flip_r = _flip_index_reduced(lmax, mmax)
    if mmax < lmax:
        Jr, Jc = J[lay.full_indices, :], J[:, lay.full_indices]
    else:
        Jr, Jc = J, J
    # to_edge: W1 = [J | JP]; W2 = [[Jr | Jr P] ; P_r [Jr | Jr P]]
    W1_to = np.concatenate([J, J[:, flip]], axis=1)
    Jp_r = np.concatenate([Jr, Jr[:, flip]], axis=1)
    W2_to = np.concatenate([Jp_r, Jp_r[flip_r, :]], axis=0)
    # from_edge (inverse stages): W1 = [Jc | -Jc P_r]; W2 = [[J | -JP] ; P .]
    W1_from = np.concatenate([Jc, -Jc[:, flip_r]], axis=1)
    Jp_i = np.concatenate([J, -J[:, flip]], axis=1)
    W2_from = np.concatenate([Jp_i, Jp_i[flip, :]], axis=0)
    Kr = len(lay.m_complex)
    m0_rows = np.nonzero(np.asarray(lay.m_complex) == 0)[0]
    m0_pair = np.concatenate([m0_rows, Kr + m0_rows])
    W = {"to": (W1_to, W2_to), "from": (W1_from, W2_from),
         "to_m0": (W1_to, W2_to[m0_pair, :]), "from_m0": (W1_from[:, m0_pair], W2_from)}
    return dict(
        absm_f=_abs_m_index(lmax), sign_f=_sign_m(lmax),
        absm_r=np.abs(lay.m_complex).astype(np.int32),
        sign_r=np.sign(lay.m_complex).astype(np.float32),
        rescale=np.asarray(lay.rescale, dtype=np.float32), m0_rows=m0_rows, Kr=Kr,
        W={k: (a.astype(np.float32), b.astype(np.float32)) for k, (a, b) in W.items()},
    )


@functools.lru_cache(maxsize=None)
def _W_tensors(lmax: int, mmax: int, kind: str, device: str):
    W1, W2 = _consts(lmax, mmax)["W"][kind]
    return torch.as_tensor(W1, device=device), torch.as_tensor(W2, device=device)


def _cs(cos_m, sin_m, absm, sign):
    """[E, K] cos / sin(m t) tables from [E, lmax+1] per-|m| tables."""
    with sync("rot_consts"):
        idx = torch.as_tensor(absm, dtype=torch.long, device=cos_m.device)
    with sync("rot_consts"):
        sgn = torch.as_tensor(sign, dtype=torch.float32, device=cos_m.device)
    return cos_m[:, idx].contiguous(), (sin_m[:, idx] * sgn[None, :]).contiguous()


def _tabs_to(w, lmax: int, mmax: int, rescale_in: bool):
    """to_edge tables; ``rescale_in`` folds the from-edge rescale into stage
    1 (the adjoint of the rescaled from_edge)."""
    k = _consts(lmax, mmax)
    c_g, s_g = _cs(w.cg, w.sg, k["absm_f"], k["sign_f"])
    c_b, s_b = _cs(w.cb, w.sb, k["absm_f"], k["sign_f"])
    c_a, s_a = _cs(w.ca, w.sa, k["absm_r"], k["sign_r"])
    if rescale_in:
        with sync("rot_consts"):
            r = torch.as_tensor(k["rescale"], device=c_g.device)[None, :]
        c_g, s_g = c_g * r, s_g * r
    return (c_g, s_g, c_b, s_b, c_a, -s_a, *_W_tensors(lmax, mmax, "to", str(c_g.device)))


def _tabs_from(w, lmax: int, mmax: int, rescale_out: bool):
    """from_edge tables; ``rescale_out`` applies the |m|-truncation rescale."""
    k = _consts(lmax, mmax)
    c_g, s_g = _cs(w.cg, w.sg, k["absm_f"], k["sign_f"])
    c_b, s_b = _cs(w.cb, w.sb, k["absm_f"], k["sign_f"])
    c_a, s_a = _cs(w.ca, w.sa, k["absm_r"], k["sign_r"])
    if rescale_out:
        with sync("rot_consts"):
            r = torch.as_tensor(k["rescale"], device=c_g.device)[None, :]
        c_g, s_g = c_g * r, s_g * r
    return (c_a, s_a, c_b, s_b, c_g, s_g, *_W_tensors(lmax, mmax, "from", str(c_g.device)))


def _slice_m0(ts, ta, lmax: int, mmax: int):
    """Restrict a (to_edge, adjoint from_edge) table pair to the m = 0
    OUTPUT rows: t3 and W2's rows of "to", t1 and W1's columns of "from"
    (the W slices are the "to_m0" / "from_m0" constants)."""
    with sync("rot_consts"):
        m0 = torch.as_tensor(_consts(lmax, mmax)["m0_rows"], dtype=torch.long,
                             device=ts[0].device)
    dev = str(ts[0].device)
    ts_m0 = (*ts[:4], ts[4][:, m0].contiguous(), ts[5][:, m0].contiguous(),
             *_W_tensors(lmax, mmax, "to_m0", dev))
    ta_m0 = (ta[0][:, m0].contiguous(), ta[1][:, m0].contiguous(), *ta[2:6],
             *_W_tensors(lmax, mmax, "from_m0", dev))
    return ts_m0, ta_m0


def tables(w, lmax: int, mmax: int, kind: str):
    """(tables of ``kind``, tables of its adjoint ``ADJOINT[kind]``), built
    once per forward and kept on the WignerFactors ``w``."""
    if kind == "from_m0":
        ts, ta = tables(w, lmax, mmax, "to_m0")
        return ta, ts

    def build(w):
        if kind == "from":
            return (_tabs_from(w, lmax, mmax, True), _tabs_to(w, lmax, mmax, True))
        pair = (_tabs_to(w, lmax, mmax, False), _tabs_from(w, lmax, mmax, False))
        return _slice_m0(*pair, lmax, mmax) if kind == "to_m0" else pair

    return w.tables((kind, lmax, mmax), build)


# ── the kernel's per-degree contract ───────────────────────────────────────


@functools.lru_cache(maxsize=None)
def kernel_segments(lmax: int, mmax: int, kind: str) -> tuple:
    """Per degree l: (input row offset, input rows, output row offset,
    output rows); the middle stage is always the full degree block
    (offset l*l, 2l+1 rows).  Mirrors the running offsets of
    ``csrc/rotate.cu``."""
    out, io, oo = [], 0, 0
    for l in range(lmax + 1):
        d, w = 2 * l + 1, 2 * min(l, mmax) + 1
        iw = {"to": d, "to_m0": d, "from": w, "from_m0": 1}[kind]
        ow = {"to": w, "to_m0": 1, "from": d, "from_m0": d}[kind]
        out.append((io, iw, oo, ow))
        io, oo = io + iw, oo + ow
    return tuple(out)


@functools.lru_cache(maxsize=None)
def kernel_pack(lmax: int, mmax: int, kind: str) -> np.ndarray:
    """The constants ``csrc/rotate.cu`` reads for one kind: per degree l,
    W1a [d, iw], W1b [d, iw], W2a [ow, d], W2b [ow, d] (row-major): the
    degree-l blocks of the two halves of W1 and of the first half of W2's
    rows.  Every other entry of W1 / W2 is zero, and W2's second half of
    rows is its first half flipped within each degree (row o of degree l
    -> ow - 1 - o), which the kernel uses and this checks."""
    W1, W2 = _consts(lmax, mmax)["W"][kind]
    segs = kernel_segments(lmax, mmax, kind)
    Ki, Km = W1.shape[1] // 2, W1.shape[0]
    Ko = W2.shape[0] // 2
    parts = []
    for l, (io, iw, oo, ow) in enumerate(segs):
        mid = np.arange(l * l, (l + 1) ** 2)
        cin, cout = np.arange(io, io + iw), np.arange(oo, oo + ow)
        if not np.array_equal(W2[Ko + cout], W2[cout[::-1]]):
            raise AssertionError(f"W2 of {kind} ({lmax}, {mmax}) is not flip-paired")
        parts += [W1[np.ix_(mid, cin)], W1[np.ix_(mid, Ki + cin)],
                  W2[np.ix_(cout, mid)], W2[np.ix_(cout, Km + mid)]]
    return np.concatenate([p.ravel() for p in parts]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _const_blob() -> tuple[np.ndarray, dict]:
    """Every instance's packs, concatenated in ``INSTANCES`` x ``KINDS``
    order, and the offset of each."""
    parts, offsets, off = [], {}, 0
    for lm in INSTANCES:
        for kind in KINDS:
            p = kernel_pack(*lm, kind)
            offsets[(*lm, kind)] = off
            parts.append(p)
            off += p.size
    return np.concatenate(parts), offsets


_consts_on_device: set = set()


def _upload_consts(lib, device: torch.device) -> None:
    """Copy the packed constants into the kernel's ``__constant__`` memory
    of ``device`` (once), after checking the library's layout."""
    from . import build

    if device.index in _consts_on_device:
        return
    blob, offsets = _const_blob()
    if lib.etq_rotate_const_floats() != blob.size:
        raise RuntimeError(f"csrc/rotate.cu holds {lib.etq_rotate_const_floats()} constants, "
                           f"ops/cuda/rotate.py packs {blob.size}")
    for (lmax, mmax, kind), off in offsets.items():
        if lib.etq_rotate_const_offset(lmax, mmax, KINDS.index(kind)) != off:
            raise RuntimeError(f"constant offset of ({lmax}, {mmax}, {kind}) differs")
    with torch.cuda.device(device):
        rc = lib.etq_rotate_set_consts(blob.ctypes.data, blob.size)
    build.check("rotate", rc, "rotate constants")
    _consts_on_device.add(device.index)


# ── the kernel and its plain version ──────────────────────────────────────


def rot_plain(x: torch.Tensor, tabs) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [E, Ki, C] -> [E, Ko, C], the
    algebra of the module docstring with the dense W1 / W2, f32 math.

    For bfloat16 input the chain stays f32 and the result is rounded once,
    as in the kernel; the JAX package rounds h and uv to bfloat16 after
    each product instead.  The gap is at most 8.4e-3 of max |JAX| for one
    rotation and 5.3e-3 on a bf16 OC20 step's forces, inside the bf16
    limits (tests/test_torch_rotate.py, tests/test_torch_oc20.py)."""
    t1a, t1b, t2a, t2b, t3a, t3b, W1, W2 = tabs
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    z = torch.cat([t1a[:, :, None].to(acc) * xf, t1b[:, :, None].to(acc) * xf], dim=1)
    h = torch.einsum("mk,ekc->emc", W1.to(acc), z)
    z2 = torch.cat([t2a[:, :, None].to(acc) * h, t2b[:, :, None].to(acc) * h], dim=1)
    uv = torch.einsum("ok,ekc->eoc", W2.to(acc), z2)
    Ko = W2.shape[0] // 2
    y = t3a[:, :, None].to(acc) * uv[:, :Ko] + t3b[:, :, None].to(acc) * uv[:, Ko:]
    return y.to(x.dtype)


def block_from_factors_plain(tabs, lmax: int, mmax: int, kind: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel's block build: the [E, P] values
    of each edge's block-diagonal matrix in K1's pair order (per degree the
    [out_w, in_w] block, row-major), from the six tables of ``tabs`` and the
    packed constants.  Per degree l, with d = 2l + 1:
    H = W1a diag(t1a) + W1b diag(t1b) [d, in_w], G = W2a diag(t2a) + W2b
    diag(t2b) [out_w, d], and M[o, k] = t3a[o] (G H)[o, k] + t3b[o] (G H)[f,
    k] with f = out_w - 1 - o, W2's flipped second half of rows.  It equals
    ``rotate_dense.compute_wigner_dense``'s values for the same edges."""
    t1a, t1b, t2a, t2b, t3a, t3b = tabs[:6]
    W = torch.as_tensor(kernel_pack(lmax, mmax, kind), dtype=t1a.dtype, device=t1a.device)
    cols, wp = [], 0
    for l, (io, iw, oo, ow) in enumerate(kernel_segments(lmax, mmax, kind)):
        d, mid, cin, cout = 2 * l + 1, slice(l * l, (l + 1) ** 2), slice(io, io + iw), \
            slice(oo, oo + ow)
        W1a, W1b = W[wp : wp + 2 * d * iw].reshape(2, d, iw)
        W2a, W2b = W[wp + 2 * d * iw : wp + 2 * d * (iw + ow)].reshape(2, ow, d)
        H = W1a * t1a[:, None, cin] + W1b * t1b[:, None, cin]
        G = W2a * t2a[:, None, mid] + W2b * t2b[:, None, mid]
        GH = G @ H
        M = t3a[:, cout, None] * GH + t3b[:, cout, None] * GH.flip(1)
        cols.append(M.reshape(M.shape[0], -1))
        wp += 2 * d * (iw + ow)
    return torch.cat(cols, dim=1)


def rot_kernel(x: torch.Tensor, tabs, lmax: int, mmax: int, kind: str) -> torch.Tensor:
    """Launch ``csrc/rotate.cu`` on the current stream (the W pair of
    ``tabs`` is the kernel's constant memory; only its shape is checked)."""
    from . import build

    if (lmax, mmax) not in INSTANCES:
        raise ValueError(f"kernel K4 has no instance for lmax {lmax}, mmax {mmax} "
                         f"(instances: {INSTANCES})")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"rotate kernel takes float32 or bfloat16, not {x.dtype}")
    t = tabs[:6]
    if not (x.is_cuda and all(a.device == x.device for a in t)):
        raise ValueError("x and the tables must lie on the same CUDA device")
    if any(a.dtype != torch.float32 for a in t):
        raise TypeError("rotate tables must be float32")
    if not (x.is_contiguous() and all(a.is_contiguous() for a in t)):
        raise ValueError("x and the tables must be contiguous")
    E, Ki, C = x.shape
    segs = kernel_segments(lmax, mmax, kind)
    Km, Ko = (lmax + 1) ** 2, segs[-1][2] + segs[-1][3]
    want = [(E, Ki)] * 2 + [(E, Km)] * 2 + [(E, Ko)] * 2
    if (Ki != segs[-1][0] + segs[-1][1] or [tuple(a.shape) for a in t] != want
            or tuple(tabs[6].shape) != (Km, 2 * Ki) or tuple(tabs[7].shape) != (2 * Ko, 2 * Km)):
        raise ValueError(f"{kind}: x {tuple(x.shape)} / tables "
                         f"{[tuple(a.shape) for a in tabs]} do not fit lmax {lmax} mmax {mmax}")
    vec = 16 // x.element_size()
    if C % vec or x.data_ptr() % 16:
        raise ValueError(f"channels ({C}) must be a multiple of {vec}, 16-byte aligned")
    y = torch.empty((E, Ko, C), dtype=x.dtype, device=x.device)
    lib = build.library("rotate")
    _upload_consts(lib, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.etq_rotate(_DTYPE_CODE[x.dtype], KINDS.index(kind), lmax, mmax, x.data_ptr(),
                        *[a.data_ptr() for a in t], y.data_ptr(), E, C, stream)
    build.check("rotate", rc, f"rotate.{kind}")
    launches[kind] += 1
    return y


def rot(x: torch.Tensor, tabs, lmax: int, mmax: int, kind: str) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return rot_kernel(x, tabs, lmax, mmax, kind)
    return rot_plain(x, tabs)


class _RotTo(torch.autograd.Function):
    """Global frame -> edge frame ("to" / "to_m0"); backward is _RotFrom."""

    @staticmethod
    def forward(ctx, x, meta, *tabs):
        ctx.meta = meta
        ctx.save_for_backward(*tabs)
        return rot(x, tabs[:8], *meta[:3])

    @staticmethod
    def backward(ctx, g):
        tabs = ctx.saved_tensors
        lmax, mmax, kind, adj = ctx.meta
        dx = _RotFrom.apply(g.contiguous(), (lmax, mmax, adj, kind), *tabs[8:], *tabs[:8])
        return (dx, None) + (None,) * len(tabs)


class _RotFrom(torch.autograd.Function):
    """Edge frame -> global frame ("from" / "from_m0"); backward is _RotTo."""

    @staticmethod
    def forward(ctx, x, meta, *tabs):
        ctx.meta = meta
        ctx.save_for_backward(*tabs)
        return rot(x, tabs[:8], *meta[:3])

    @staticmethod
    def backward(ctx, g):
        tabs = ctx.saved_tensors
        lmax, mmax, kind, adj = ctx.meta
        dx = _RotTo.apply(g.contiguous(), (lmax, mmax, adj, kind), *tabs[8:], *tabs[:8])
        return (dx, None) + (None,) * len(tabs)


def rotate(w, x: torch.Tensor, lmax: int, mmax: int, kind: str) -> torch.Tensor:
    """Any kind through its autograd Function (``_RotTo`` for "to" /
    "to_m0", ``_RotFrom`` for "from" / "from_m0")."""
    fn = _RotTo if kind in ("to", "to_m0") else _RotFrom
    ts, ta = tables(w, lmax, mmax, kind)
    return fn.apply(x.contiguous(), (lmax, mmax, kind, ADJOINT[kind]), *ts, *ta)


def rotate_to_edge_fused(w, x: torch.Tensor, layout) -> torch.Tensor:
    """[E, K_full, C] -> [E, K_red, C]."""
    return rotate(w, x, layout.lmax, layout.mmax, "to")


def rotate_to_edge_m0_fused(w, x: torch.Tensor, layout) -> torch.Tensor:
    """[E, K_full, C] -> [E, lmax+1, C]: only the m = 0 output rows."""
    return rotate(w, x, layout.lmax, layout.mmax, "to_m0")


def rotate_from_edge_fused(w, x: torch.Tensor, layout) -> torch.Tensor:
    """[E, K_red, C] -> [E, K_full, C], truncation rescale applied."""
    return rotate(w, x, layout.lmax, layout.mmax, "from")
