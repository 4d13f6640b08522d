"""K3: fused SO(2) convolution (every m-group of a site in one launch) and
its adjoint, for Hopper.

Port of the JAX package's ops/pallas/so2conv.py (kernels ``_fwd_kernel`` and
``_adj_kernel``).  A conv site is one GEMM per m-group g with a packed weight
``W_g [rows_g * Cin, N_g]`` (m = 0: ``[w_m0]`` with the extra columns first;
m > 0: the butterfly ``[[wr, wi], [-wi, wr]]``).  The kernels in
``csrc/so2conv.cu`` read the group's input rows straight from the l-primary
tensor and write its outputs straight to l-primary rows, so the
``to_m_perm`` / ``from_m_perm`` copies and the output concatenation of the
unfused path disappear.  The kernels run on the tensor cores: float32 as
3xTF32 (three TF32 products per f32 product, within the f32 limit),
bfloat16 as bf16 products with f32 accumulation.  Their B operand is the
weight with the GEMM depth contiguous (``b_operands``: the forward's
``W_g^T``, the adjoint's ``W_g`` as it lies), split into TF32 big and small
parts in float32, made once per call by ``b_operand_kernel`` (plain
version ``b_operands_plain``, rounding as ``tf32_round``).

Differentiation mirrors the JAX package's custom_vjp pair ``_core`` /
``_core_adj``: the operator is bilinear in (x, W).  The backward of
``_SO2Conv`` is ``_SO2ConvAdj`` (the adjoint kernel) for dx plus
``dW_g = X_g^T [dextra | dY rows]``; the backward of ``_SO2ConvAdj`` is
``_SO2Conv`` plus the same product.  dW is K3-dW (``dws``: one launch of
``so2conv_dw_kernel`` and its reduce per call, every group at once), inside
``_SO2ConvDW``, which is bilinear in (X, Y) too: its backward is
``_SO2ConvAdj`` for X and ``_SO2Conv`` for Y, with the upstream gradients
as weights, so grad-of-grad works to any order on the kernels alone.  The
JAX package leaves dW to XLA.

``live`` (``so2conv_fused``'s argument): a device int32 scalar such that the
cotangents (dy, dextra) of the site's outputs are zero in rows ``[live,
E)``, as in the ragged layout, whose padding edges lie at the tail and take
zero gradients (``models/backbone.py`` makes it); K3-dW then reduces rows
``[0, live)`` only, the same sum.  None reduces every row.  It holds for
the cotangents of the model's own outputs: the convolution that
``_SO2ConvAdj``'s and ``_SO2ConvDW``'s backwards run on upstream gradients
takes none.  ``dw_rows`` (device int64: rows reduced, rows offered, summed
over calls) counts what the skip saves; nothing in a step reads it.

CPU tensors run the plain versions ``fwd_plain`` / ``adj_plain`` /
``dws_plain``; CUDA tensors launch the kernels; nothing falls back.  ``so2conv_supported`` gives
the kernel's own shape limits (every row segment a multiple of 8 wide); a
site outside them takes the unfused path in nn/so3_layers.py, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..irreps import IrrepsLayout
from ..irreps import layout as get_layout

__all__ = ["so2conv_fused", "so2conv_supported", "fwd_plain", "adj_plain", "dws_plain", "dws",
           "launches", "dw_rows", "tf32_round", "b_operands", "b_operands_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WIDTH = 8                  # csrc/so2conv.cu: CHUNK, the segment-width quantum
_MAX_GROUPS, _MAX_ROWS = 8, 16

# kernel launches (the launch wrappers add one per launch; "dw" one per
# K3-dW call, its kernel and its reduce)
launches = {"fwd": 0, "adj": 0, "b_operands": 0, "dw": 0}
_DW_TILE = 128              # csrc/so2conv.cu: DW_BM = DW_BN, a dW tile's side
_DW_WAVES = 8               # K3-dW's blocks: at least this many per SM
_dw_rows: dict = {}         # device -> int64 [rows reduced, rows offered]


def dw_rows(device) -> torch.Tensor:
    """K3-dW's rows reduced and rows offered on ``device``, summed over its
    calls since the process started (int64, on the device; block 0 of each
    launch adds its call's ``live`` and E)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _dw_rows:
        _dw_rows[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return _dw_rows[device]


@functools.lru_cache(maxsize=None)
def _row_maps(lmax: int, mmax: int) -> tuple[np.ndarray, ...]:
    """Per m-group g (g = 0 is m = 0): the l-primary rows feeding the
    group's GEMM, in the m-primary order the packed weight expects (real
    rows, then imaginary rows, for m > 0).  The same rows receive the
    group's outputs."""
    lay = get_layout(lmax, mmax)
    perm = np.asarray(lay.to_m_perm)
    sizes = [int(lay.m_size[0])] + [2 * int(lay.m_size[m]) for m in range(1, mmax + 1)]
    bounds = np.cumsum([0] + sizes)
    return tuple(perm[bounds[g]:bounds[g + 1]].copy() for g in range(len(sizes)))


@functools.lru_cache(maxsize=None)
def _row_index(lmax: int, mmax: int, device: str) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(r, dtype=torch.long, device=device)
                 for r in _row_maps(lmax, mmax))


@functools.lru_cache(maxsize=None)
def _c_tables(lmax: int, mmax: int):
    groups = _row_maps(lmax, mmax)
    rows = (ctypes.c_int * len(groups))(*[len(r) for r in groups])
    flat = np.concatenate(groups)
    lrows = (ctypes.c_int * len(flat))(*[int(v) for v in flat])
    return rows, lrows


def so2conv_supported(layout: IrrepsLayout, Cin: int, Cout: int, extra: int) -> bool:
    """Shapes the kernel takes: Cin, Cout and extra multiples of 8 (one
    8-wide chunk of a stage never crosses a row segment), at most 8 m-groups
    of at most 16 rows."""
    groups = _row_maps(layout.lmax, layout.mmax)
    return (Cin % _WIDTH == 0 and Cout % _WIDTH == 0 and extra % _WIDTH == 0
            and len(groups) <= _MAX_GROUPS and max(map(len, groups)) <= _MAX_ROWS)


# ── plain versions ────────────────────────────────────────────────────────


def fwd_plain(x: torch.Tensor, ws, lmax: int, mmax: int, Cout: int,
              extra: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain version of K3-fwd: x [E, K, Cin] -> (y [E, K, Cout],
    extra [E, extra] | None), f32 accumulation."""
    E, K, _ = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.empty(E, K, Cout, dtype=acc, device=x.device)
    ex = None
    for g, rows in enumerate(_row_index(lmax, mmax, str(x.device))):
        out = x.index_select(1, rows).reshape(E, -1).to(acc) @ ws[g].to(acc)
        if g == 0 and extra:
            ex, out = out[:, :extra], out[:, extra:]
        y[:, rows, :] = out.reshape(E, len(rows), Cout)
    return y.to(x.dtype), None if ex is None else ex.to(x.dtype)


def adj_plain(dy: torch.Tensor, dextra: torch.Tensor | None, ws, lmax: int,
              mmax: int, Cin: int) -> torch.Tensor:
    """Plain version of K3-adj: dx [E, K, Cin] from dy [E, K, Cout] and
    dextra [E, extra] | None, f32 accumulation."""
    E, K, _ = dy.shape
    acc = torch.promote_types(dy.dtype, torch.float32)
    dx = torch.empty(E, K, Cin, dtype=acc, device=dy.device)
    for g, rows in enumerate(_row_index(lmax, mmax, str(dy.device))):
        dY = _group_rows(dy, dextra if g == 0 else None, rows).to(acc)
        dx[:, rows, :] = (dY @ ws[g].to(acc).t()).reshape(E, len(rows), Cin)
    return dx.to(dy.dtype)


def dws_plain(x: torch.Tensor, y: torch.Tensor, y_extra: torch.Tensor | None, lmax: int,
              mmax: int, live: torch.Tensor | int | None = None) -> list[torch.Tensor]:
    """Plain version of K3-dW: dW_g = [rows of x]^T @ [y_extra (g = 0) | rows
    of y] over the rows ``[0, live)`` (None: all), f32 accumulation, in x's
    type."""
    n = x.shape[0] if live is None else min(max(int(live), 0), x.shape[0])
    x, y = x[:n], y[:n]
    y_extra = None if y_extra is None else y_extra[:n]
    acc = torch.promote_types(x.dtype, torch.float32)
    out = []
    for g, rows in enumerate(_row_index(lmax, mmax, str(x.device))):
        xg = _group_rows(x, None, rows).to(acc)
        yg = _group_rows(y, y_extra if g == 0 else None, rows).to(acc)
        out.append((xg.t() @ yg).to(x.dtype))
    return out


def _group_rows(t: torch.Tensor, lead: torch.Tensor | None, rows) -> torch.Tensor:
    """[lead | t[:, rows[0], :] | t[:, rows[1], :] | ...] as [E, width]."""
    flat = t.index_select(1, rows).reshape(t.shape[0], len(rows) * t.shape[2])
    return flat if lead is None else torch.cat([lead, flat], dim=1)


# ── the kernels ───────────────────────────────────────────────────────────


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest on
    the 13 low mantissa bits, ties away from zero; the low bits come out 0.
    Non-finite values pass through."""
    bits = t.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(t), r, t)


def b_operands_plain(ws, adjoint: bool) -> tuple[list[torch.Tensor], list[torch.Tensor] | None]:
    """The kernel's B operand of each group, ``[ndim, kdim]`` with the GEMM
    depth contiguous (the tensor cores take TF32 operands that way only):
    the forward's ``W_g^T``, the adjoint's ``W_g`` as it lies.  float32:
    (TF32 big parts, TF32 small parts), big + small = W to ~2^-22 relative;
    bfloat16: (the operands, None)."""
    bs = [w if adjoint else w.t().contiguous() for w in ws]
    if bs[0].dtype != torch.float32:
        return bs, None
    hi = [tf32_round(b) for b in bs]
    return hi, [tf32_round(b - h) for b, h in zip(bs, hi)]


def b_operands(ws, adjoint: bool) -> tuple[list[torch.Tensor], list[torch.Tensor] | None]:
    """``b_operands_plain`` on CPU tensors; on CUDA tensors one launch of
    ``csrc/so2conv.cu:b_operand_kernel`` per group (the bfloat16 adjoint
    takes W as it lies and launches nothing)."""
    from . import build

    if not ws[0].is_cuda:
        return b_operands_plain(ws, adjoint)
    if ws[0].dtype not in _DTYPE_CODE or not all(
            w.is_contiguous() and w.dim() == 2 and w.dtype == ws[0].dtype
            and w.device == ws[0].device for w in ws):
        raise ValueError("so2conv B operands: contiguous 2-D float32 or bfloat16 weights "
                         "on one device")
    f32 = ws[0].dtype == torch.float32
    if adjoint and not f32:
        return list(ws), None
    lib = build.library("so2conv")
    stream = torch.cuda.current_stream(ws[0].device).cuda_stream
    hi, lo = [], []
    for w in ws:
        R, N = w.shape
        shape = (R, N) if adjoint else (N, R)
        hi.append(torch.empty(shape, dtype=w.dtype, device=w.device))
        lo.append(torch.empty(shape, dtype=w.dtype, device=w.device) if f32 else None)
        rc = lib.etq_so2conv_b(_DTYPE_CODE[w.dtype], int(not adjoint), R, N, w.data_ptr(),
                               hi[-1].data_ptr(), lo[-1].data_ptr() if f32 else None, stream)
        build.check("so2conv", rc, "so2conv.b_operands")
        launches["b_operands"] += 1
    return hi, lo if f32 else None


def _launch(adjoint: bool, a: torch.Tensor, a_extra: torch.Tensor | None, ws,
            lmax: int, mmax: int, c_out: int, extra: int):
    """Launch ``csrc/so2conv.cu`` on the current stream.  Forward: a = x,
    returns (y, extra | None); adjoint: a = dy, a_extra = dextra, returns dx."""
    from . import build

    groups = _row_maps(lmax, mmax)
    E, K, c_in = a.shape
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"so2conv kernel takes float32 or bfloat16, not {a.dtype}")
    if K != sum(map(len, groups)):
        raise ValueError(f"a has {K} rows; lmax {lmax} mmax {mmax} has {sum(map(len, groups))}")
    if min(c_in, c_out) % _WIDTH or extra % _WIDTH:
        raise ValueError(f"so2conv kernel needs channel widths that are multiples of "
                         f"{_WIDTH} (got {c_in}, {c_out}, extra {extra})")
    cin_f, cout_f = (c_out, c_in) if adjoint else (c_in, c_out)
    tensors = [a, *ws] + ([a_extra] if adjoint and extra else [])
    for g, rows in enumerate(groups):
        want = (len(rows) * cin_f, (extra if g == 0 else 0) + len(rows) * cout_f)
        if tuple(ws[g].shape) != want:
            raise ValueError(f"W_{g} has shape {tuple(ws[g].shape)}, expected {want}")
    if adjoint and extra and tuple(a_extra.shape) != (E, extra):
        raise ValueError(f"dextra has shape {tuple(a_extra.shape)}, expected {(E, extra)}")
    for t in tensors:
        if not (t.is_cuda and t.device == a.device and t.dtype == a.dtype):
            raise ValueError("so2conv inputs must share one CUDA device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("so2conv inputs must be contiguous and 16-byte aligned")
    out = torch.empty(E, K, c_out, dtype=a.dtype, device=a.device)
    out_extra = (torch.empty(E, extra, dtype=a.dtype, device=a.device)
                 if extra and not adjoint else None)
    rows_c, lrows_c = _c_tables(lmax, mmax)
    hi, lo = b_operands(ws, adjoint)
    hi_ptrs = (ctypes.c_void_p * len(hi))(*[b.data_ptr() for b in hi])
    lo_ptrs = None if lo is None else (ctypes.c_void_p * len(lo))(*[b.data_ptr() for b in lo])
    lib = build.library("so2conv")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    rc = lib.etq_so2conv(
        _DTYPE_CODE[a.dtype], int(adjoint), E, K, c_in, c_out, len(groups),
        ctypes.addressof(rows_c), ctypes.addressof(lrows_c), extra, a.data_ptr(),
        a_extra.data_ptr() if adjoint and extra else 0, ctypes.addressof(hi_ptrs),
        None if lo_ptrs is None else ctypes.addressof(lo_ptrs),
        out.data_ptr(), 0 if out_extra is None else out_extra.data_ptr(), stream,
    )
    build.check("so2conv", rc, "so2conv.adj" if adjoint else "so2conv.fwd")
    launches["adj" if adjoint else "fwd"] += 1
    return out if adjoint else (out, out_extra)


def fwd(x: torch.Tensor, ws, lmax: int, mmax: int, Cout: int, extra: int):
    """K3-fwd on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return _launch(False, x, None, ws, lmax, mmax, Cout, extra)
    return fwd_plain(x, ws, lmax, mmax, Cout, extra)


def adj(dy: torch.Tensor, dextra: torch.Tensor | None, ws, lmax: int, mmax: int,
        Cin: int) -> torch.Tensor:
    """K3-adj on a CUDA tensor, its plain version on a CPU tensor."""
    if dy.is_cuda:
        extra = 0 if dextra is None else dextra.shape[1]
        return _launch(True, dy, dextra, ws, lmax, mmax, Cin, extra)
    return adj_plain(dy, dextra, ws, lmax, mmax, Cin)


def _dw_slices(tiles: int, E: int, device: torch.device) -> int:
    """Depth slices of each dW tile: enough blocks for ``_DW_WAVES`` per SM,
    each slice at least 4 stages of E's 32-row stages."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-_DW_WAVES * sms // tiles), E // 128))


def _launch_dw(x: torch.Tensor, y: torch.Tensor, y_extra: torch.Tensor | None, lmax: int,
               mmax: int, live: torch.Tensor | None) -> list[torch.Tensor]:
    """Launch ``csrc/so2conv.cu:so2conv_dw_kernel`` and its reduce on the
    current stream: dW_g of every group in x's type."""
    from . import build

    groups = _row_maps(lmax, mmax)
    E, K, c_in = x.shape
    c_out = y.shape[2]
    extra = 0 if y_extra is None else y_extra.shape[1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"so2conv dW kernel takes float32 or bfloat16, not {x.dtype}")
    if K != sum(map(len, groups)) or tuple(y.shape[:2]) != (E, K):
        raise ValueError(f"x {tuple(x.shape)} / y {tuple(y.shape)}: lmax {lmax} mmax {mmax} "
                         f"has {sum(map(len, groups))} rows")
    if min(c_in, c_out) % _WIDTH or extra % _WIDTH:
        raise ValueError(f"so2conv dW kernel needs channel widths that are multiples of "
                         f"{_WIDTH} (got {c_in}, {c_out}, extra {extra})")
    if y_extra is not None and tuple(y_extra.shape) != (E, extra):
        raise ValueError(f"y_extra has shape {tuple(y_extra.shape)}, expected {(E, extra)}")
    for t in (x, y) + (() if y_extra is None else (y_extra,)):
        if not (t.is_cuda and t.device == x.device and t.dtype == x.dtype):
            raise ValueError("so2conv dW inputs must share one CUDA device and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("so2conv dW inputs must be contiguous and 16-byte aligned")
    if live is not None and not (live.is_cuda and live.device == x.device
                                 and live.dtype == torch.int32 and live.numel() == 1):
        raise ValueError("so2conv dW: live must be an int32 scalar on x's device")
    shapes = [(len(r) * c_in, (extra if g == 0 else 0) + len(r) * c_out)
              for g, r in enumerate(groups)]
    tiles = sum(-(-k // _DW_TILE) * -(-n // _DW_TILE) for k, n in shapes)
    slices = _dw_slices(tiles, E, x.device)
    work = torch.empty(slices * tiles * _DW_TILE * _DW_TILE, dtype=torch.float32,
                       device=x.device)
    out = [torch.empty(s, dtype=x.dtype, device=x.device) for s in shapes]
    out_ptrs = (ctypes.c_void_p * len(out))(*[o.data_ptr() for o in out])
    rows_c, lrows_c = _c_tables(lmax, mmax)
    lib = build.library("so2conv")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.etq_so2conv_dw(
        _DTYPE_CODE[x.dtype], E, K, c_in, c_out, len(groups), ctypes.addressof(rows_c),
        ctypes.addressof(lrows_c), extra, x.data_ptr(), y.data_ptr(),
        0 if y_extra is None else y_extra.data_ptr(), 0 if live is None else live.data_ptr(),
        dw_rows(x.device).data_ptr(), slices, work.data_ptr(), ctypes.addressof(out_ptrs),
        stream,
    )
    build.check("so2conv", rc, "so2conv.dw")
    launches["dw"] += 1
    return out


def dws(x: torch.Tensor, y: torch.Tensor, y_extra: torch.Tensor | None, lmax: int, mmax: int,
        live: torch.Tensor | None = None) -> list[torch.Tensor]:
    """K3-dW on CUDA tensors, its plain version on CPU tensors: dW_g of
    every group over the rows ``[0, live)`` (None: all)."""
    if x.is_cuda:
        return _launch_dw(x, y, y_extra, lmax, mmax, live)
    return dws_plain(x, y, y_extra, lmax, mmax, live)


# ── differentiable core (the JAX package's mutual custom_vjp pair) ─────────


class _Aux:
    """Static configuration of one conv site, and its ``live`` rows (None:
    every row); ``whole`` is the same site without them."""

    def __init__(self, lmax: int, mmax: int, Cin: int, Cout: int, extra: int,
                 live: torch.Tensor | None = None):
        self.lmax, self.mmax = lmax, mmax
        self.Cin, self.Cout, self.extra = Cin, Cout, extra
        self.live = live
        self.whole = self if live is None else _Aux(lmax, mmax, Cin, Cout, extra)


def _weight_grads(x, y, y_extra, aux: _Aux, ws) -> list[torch.Tensor]:
    """dW_g of every group in each weight's type, through ``_SO2ConvDW``."""
    return [d.to(w.dtype) for d, w in zip(_SO2ConvDW.apply(x, y, y_extra, aux), ws)]


class _SO2ConvDW(torch.autograd.Function):
    """dW_g = X_g^T Y_g (K3-dW) for every group; bilinear in (x, (y,
    y_extra)), so for upstream gradients G_g the gradient in x is the adjoint
    with weights G and the gradient in (y, y_extra) the forward with weights
    G."""

    @staticmethod
    def forward(ctx, x, y, y_extra, aux: _Aux):
        ctx.save_for_backward(x, y, y_extra)
        ctx.aux = aux
        return tuple(dws(x, y, y_extra, aux.lmax, aux.mmax, aux.live))

    @staticmethod
    def backward(ctx, *gs):
        x, y, y_extra = ctx.saved_tensors
        aux = ctx.aux
        gs = [g.contiguous() for g in gs]
        dx = _SO2ConvAdj.apply(y, y_extra, aux, *gs) if ctx.needs_input_grad[0] else None
        dy = dy_extra = None
        if any(ctx.needs_input_grad[1:3]):
            out = _SO2Conv.apply(x, aux.whole, *gs)
            dy, dy_extra = out if aux.extra else (out, None)
        return dx, dy, dy_extra, None


class _SO2Conv(torch.autograd.Function):
    """(y, extra) = conv(x, W); backward is _SO2ConvAdj plus dW."""

    @staticmethod
    def forward(ctx, x, aux: _Aux, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.aux = aux
        y, ex = fwd(x, ws, aux.lmax, aux.mmax, aux.Cout, aux.extra)
        return (y, ex) if aux.extra else y

    @staticmethod
    def backward(ctx, dy, dextra=None):
        x, *ws = ctx.saved_tensors
        aux = ctx.aux
        dy = dy.contiguous()
        dextra = dextra.contiguous() if aux.extra else None
        dx = _SO2ConvAdj.apply(dy, dextra, aux, *ws) if ctx.needs_input_grad[0] else None
        dw = (_weight_grads(x, dy, dextra, aux, ws) if any(ctx.needs_input_grad[2:])
              else [None] * len(ws))
        return (dx, None, *dw)


class _SO2ConvAdj(torch.autograd.Function):
    """dx = adj(dy, dextra, W), linear in (dy, dextra); backward is
    _SO2Conv plus dW."""

    @staticmethod
    def forward(ctx, dy, dextra, aux: _Aux, *ws):
        ctx.save_for_backward(dy, dextra, *ws)
        ctx.aux = aux
        return adj(dy, dextra, ws, aux.lmax, aux.mmax, aux.Cin)

    @staticmethod
    def backward(ctx, ddx):
        dy, dextra, *ws = ctx.saved_tensors
        aux = ctx.aux
        ddx = ddx.contiguous()
        ddy = ddextra = None
        if any(ctx.needs_input_grad[:2]):
            out = _SO2Conv.apply(ddx, aux.whole, *ws)
            ddy, ddextra = out if aux.extra else (out, None)
        dw = (_weight_grads(ddx, dy, dextra, aux, ws) if any(ctx.needs_input_grad[3:])
              else [None] * len(ws))
        return (ddy, ddextra, None, *dw)


def so2conv_fused(x: torch.Tensor, ws, lmax: int, mmax: int, Cout: int, extra: int,
                  live: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Fused SO(2) conv.  x: [E, K_red, Cin] l-primary (radial scaling, if
    any, already applied); ws: per-group packed weights (m = 0:
    [L0 Cin, extra + L0 Cout]; m > 0: butterfly [2 Lm Cin, 2 Lm Cout]);
    ``live``: a device int32 scalar when the outputs' cotangents are zero in
    rows ``[live, E)`` (module doc).  Returns (y [E, K_red, Cout], extra
    [E, extra] | None)."""
    aux = _Aux(lmax, mmax, x.shape[2], Cout, extra, live)
    out = _SO2Conv.apply(x.contiguous(), aux, *[w.contiguous() for w in ws])
    return out if extra else (out, None)
