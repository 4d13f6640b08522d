"""K5: GATA-V2's value activation and its two adjoints, fused, for Hopper.

The elementwise body of nn/gata.py:GATAValueActivation after its three
linears (the JAX package has no kernel here; XLA fuses it).  With S =
1 + 2 lmax gate chunks of C channels and w(l) = min(2l+1, 2 mmax+1):

    comb = a + r * silu(g) [* p]                  a, r, g, p: [E, S C]
    out[:, 0]       = silu(comb[:, 0:C])
    out[:, R(l, i)] = comb_l * rl[:, off(l) + i] + comb_{lmax+l} * xp[:, off(l) + i]

for i < w(l), off(l) = l^2 - 1 the degree's first row of xp [E, K-1, C]
and rl [E, K-1]; out is [E, K_red, C] (K_red = 1 + sum_l w(l)).  Eagerly
this is ~1,500 launches a MatPES force-training step; the kernels in
``csrc/gata_value.cu`` make each pass one launch:

* K5a: ``out``;
* K5b: the gradients of a, r, g, p, xp, rl from ``dout`` (the backward of
  K5a; xp's unused rows zero);
* K5c: the vjp of K5b (the backward of K5b), for the cotangents of its
  outputs: the gradients of the six inputs and of ``dout``, which force
  training runs in the loss backward.

``gata_value`` sits in ``_GataValue`` (backward = ``_GataValueBackward``,
i.e. K5b), whose backward is ``_GataValueGradOfGrad`` (K5c); K5c's own
backward raises (third order is not supported).  A gradient nobody needs
is not computed: K5b and K5c take the inputs' ``needs_input_grad`` and
leave those outputs out (None), and a cotangent that is None reads as
zero.  ``a`` may have a row stride (a column slice); every other input is
made contiguous.  CPU tensors run the plain versions (``k5a_plain``, the
module's eager arithmetic, and ``k5b_plain`` / ``k5c_plain``, the same
formulas as the kernels in float32 or wider); CUDA tensors launch the
kernels or raise; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as Fn

__all__ = ["gata_value", "k5a", "k5b", "k5c", "k5a_plain", "k5b_plain", "k5c_plain",
           "KERNELS", "LMAX_INSTANCES", "MAX_C", "launches", "out_rows"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# K5a, K5b, K5c by their number in csrc/gata_value.cu (KIND)
KERNELS = ("k5a", "k5b", "k5c")
# the lmax values with a kernel instance, and the widest C the kernels take
LMAX_INSTANCES = (1, 2, 3, 4, 6)
MAX_C = 128
# kernel launches (the launch wrapper adds one per launch)
launches = {k: 0 for k in KERNELS}
# the pointer slots of the C entry: inputs, then outputs (K5a writes its
# output, which has dout's shape, in the "dout" output slot)
IN_SLOTS = ("a", "r", "g", "p", "xp", "rl", "dout", "ga", "gr", "gg", "gp", "gxp", "grl")
OUT_SLOTS = ("a", "r", "g", "p", "xp", "rl", "dout")


def out_rows(lmax: int, mmax: int) -> list[int]:
    """w(l) = min(2l+1, 2 mmax+1) for l = 1..lmax: the rows each degree keeps."""
    return [min(2 * l + 1, 2 * mmax + 1) for l in range(1, lmax + 1)]


def k5a_plain(a, r, g, p, xp, rl, lmax: int, mmax: int) -> torch.Tensor:
    """Plain version of K5a: GATAValueActivation's eager arithmetic."""
    C = xp.shape[2]
    bias = r * Fn.silu(g)
    if p is not None:
        bias = bias * p
    combined = a + bias
    out = [Fn.silu(combined[:, :C])[:, None, :]]
    offset = 0
    for l, w in enumerate(out_rows(lmax, mmax), start=1):
        Xl = xp[:, offset : offset + w, :]
        rl_l = rl[:, offset : offset + w, None]
        offset += 2 * l + 1
        od = combined[:, l * C : (l + 1) * C][:, None, :]
        ot = combined[:, (lmax + l) * C : (lmax + l + 1) * C][:, None, :]
        out.append(od * rl_l + ot * Xl)
    return torch.cat(out, dim=1)


def _silu_parts(x: torch.Tensor):
    """silu(x), silu'(x), silu''(x)."""
    s = torch.sigmoid(x)
    return x * s, s * (1.0 + x * (1.0 - s)), s * (1.0 - s) * (2.0 + x * (1.0 - 2.0 * s))


def _chunks(a, r, g, p, lmax: int, C: int):
    """a, r, g, p as [E, S, C] in the accumulation type (p: ones if absent)."""
    E, S = r.shape[0], 1 + 2 * lmax
    acc = torch.promote_types(r.dtype, torch.float32)
    A, R, G = (t.to(acc).reshape(E, S, C) for t in (a, r, g))
    P = p.to(acc).reshape(E, S, C) if p is not None else torch.ones_like(R)
    return A, R, G, P, acc


def _degrees(lmax: int, mmax: int):
    """(l, w, off, rb): each degree's kept rows, first xp row and first out row."""
    rb = 1
    for l, w in enumerate(out_rows(lmax, mmax), start=1):
        yield l, w, l * l - 1, rb
        rb += w


def k5b_plain(a, r, g, p, xp, rl, dout, lmax: int, mmax: int) -> tuple:
    """Plain version of K5b: (da, dr, dg, dp, dxp, drl), dp None without p."""
    E, C = xp.shape[0], xp.shape[2]
    A, R, G, P, acc = _chunks(a, r, g, p, lmax, C)
    X, Q, do = xp.to(acc), rl.to(acc), dout.to(acc)
    s, s1, _ = _silu_parts(G)
    comb = A + R * s * P
    D = torch.empty_like(comb)
    D[:, 0] = do[:, 0] * _silu_parts(comb[:, 0])[1]
    dxp, drl = torch.zeros_like(X), torch.zeros_like(Q)
    for l, w, off, rb in _degrees(lmax, mmax):
        dR = do[:, rb : rb + w]
        D[:, l] = (dR * Q[:, off : off + w, None]).sum(1)
        D[:, lmax + l] = (dR * X[:, off : off + w]).sum(1)
        dxp[:, off : off + w] = dR * comb[:, lmax + l, None]
        drl[:, off : off + w] = (dR * comb[:, l, None]).sum(2)
    flat = lambda t: t.reshape(E, -1).to(r.dtype)  # noqa: E731
    return (flat(D), flat(D * s * P), flat(D * R * P * s1),
            flat(D * R * s) if p is not None else None, dxp.to(r.dtype), drl.to(r.dtype))


def k5c_plain(a, r, g, p, xp, rl, dout, ga, gr, gg, gp, gxp, grl, lmax: int,
              mmax: int) -> tuple:
    """Plain version of K5c: the vjp of K5b at (a, r, g, p, xp, rl, dout)
    for the cotangents (ga, gr, gg, gp, gxp, grl) of its outputs (None:
    zero); returns the gradients of (a, r, g, p, xp, rl, dout), p's None
    without p."""
    E, C = xp.shape[0], xp.shape[2]
    A, R, G, P, acc = _chunks(a, r, g, p, lmax, C)
    X, Q, do = xp.to(acc), rl.to(acc), dout.to(acc)
    zero = torch.zeros_like(R)
    Ga, Gr, Gg, Gp = (t.to(acc).reshape(E, -1, C) if t is not None else zero
                      for t in (ga, gr, gg, gp))
    Gx = gxp.to(acc) if gxp is not None else torch.zeros_like(X)
    Gq = grl.to(acc) if grl is not None else torch.zeros_like(Q)
    s, s1, s2 = _silu_parts(G)
    comb = A + R * s * P
    H = Ga + Gr * s * P + Gg * R * P * s1 + Gp * R * s   # the cotangent of D
    D, Gc = torch.empty_like(comb), torch.empty_like(comb)  # Gc: of comb
    c1, c2 = _silu_parts(comb[:, 0])[1:]
    D[:, 0] = do[:, 0] * c1
    Gc[:, 0] = H[:, 0] * do[:, 0] * c2
    gdo = torch.empty_like(do)
    gdo[:, 0] = H[:, 0] * c1
    gx, gq = torch.zeros_like(X), torch.zeros_like(Q)
    for l, w, off, rb in _degrees(lmax, mmax):
        dR, Xl, Ql = do[:, rb : rb + w], X[:, off : off + w], Q[:, off : off + w, None]
        Gxl, Gql = Gx[:, off : off + w], Gq[:, off : off + w, None]
        D[:, l] = (dR * Ql).sum(1)
        D[:, lmax + l] = (dR * Xl).sum(1)
        Gc[:, l] = (Gql * dR).sum(1)
        Gc[:, lmax + l] = (Gxl * dR).sum(1)
        Hl, Ht = H[:, l, None], H[:, lmax + l, None]
        gx[:, off : off + w] = Ht * dR
        gq[:, off : off + w] = (Hl * dR).sum(2)
        gdo[:, rb : rb + w] = (Hl * Ql + Ht * Xl + Gxl * comb[:, lmax + l, None]
                               + Gql * comb[:, l, None])
    g_a = Gc
    g_r = Gc * s * P + D * (Gg * P * s1 + Gp * s)
    g_g = Gc * R * P * s1 + D * (Gr * P * s1 + Gg * R * P * s2 + Gp * R * s1)
    g_p = Gc * R * s + D * (Gr * s + Gg * R * s1)
    flat = lambda t: t.reshape(E, -1).to(r.dtype)  # noqa: E731
    return (flat(g_a), flat(g_r), flat(g_g), flat(g_p) if p is not None else None,
            gx.to(r.dtype), gq.to(r.dtype), gdo.to(r.dtype))


def _check(a, r, g, p, xp, rl, lmax: int, mmax: int) -> None:
    E, K1, C = xp.shape
    S = 1 + 2 * lmax
    if K1 != lmax * (lmax + 2) or rl.shape != (E, K1):
        raise ValueError(f"gata_value: xp {tuple(xp.shape)} / rl {tuple(rl.shape)} do not "
                         f"hold the {lmax * (lmax + 2)} rows of lmax {lmax}")
    for name, t in (("a", a), ("r", r), ("g", g), ("p", p)):
        if t is not None and t.shape != (E, S * C):
            raise ValueError(f"gata_value: {name} is {tuple(t.shape)}, not ({E}, {S * C})")
    if not 0 <= mmax <= lmax:
        raise ValueError(f"gata_value: mmax {mmax} outside [0, lmax {lmax}]")


def _launch(kernel: int, lmax: int, mmax: int, ins: dict, outs: dict) -> None:
    """Launch K5a, K5b or K5c (``kernel`` 0, 1, 2) on the named inputs and
    outputs (``IN_SLOTS`` / ``OUT_SLOTS``; absent: None)."""
    from . import build

    a, xp = ins["a"], ins["xp"]
    E, _, C = xp.shape
    dt = xp.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"gata_value kernel takes float32 or bfloat16, not {dt}")
    if lmax not in LMAX_INSTANCES:
        raise ValueError(f"gata_value: no kernel instance for lmax {lmax} ({LMAX_INSTANCES})")
    if C % 8 or C > MAX_C:
        raise ValueError(f"gata_value: C = {C} channels; the kernels take a multiple of 8 "
                         f"up to {MAX_C}")
    tensors = [t for t in (*ins.values(), *outs.values()) if t is not None]
    for t in tensors:
        if t.dtype != dt or t.device != xp.device:
            raise ValueError("gata_value: every input and output must share xp's dtype "
                             "and device")
        if t is not a and not t.is_contiguous():
            raise ValueError("gata_value: inputs other than a must be contiguous")
    if a.stride(1) != 1 or a.stride(0) % 8 or a.data_ptr() % 16:
        raise ValueError("gata_value: a's rows must be contiguous and 16-byte aligned")
    ptrs = (ctypes.c_void_p * (len(IN_SLOTS) + len(OUT_SLOTS)))(
        *[t.data_ptr() if t is not None else None for t in
          (*(ins.get(k) for k in IN_SLOTS), *(outs.get(k) for k in OUT_SLOTS))])
    lib = build.library("gata_value")
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.etq_gata_value(_DTYPE_CODE[dt], kernel, lmax, mmax, E, C, a.stride(0),
                            ctypes.cast(ptrs, ctypes.c_void_p), stream)
    name = KERNELS[kernel]
    build.check("gata_value", rc, f"gata_value.{name}")
    launches[name] += 1


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """``a`` as the kernels read it: a row-strided view where its rows are
    contiguous and 16-byte aligned (a row stride of 8 elements), else a
    contiguous copy."""
    if a.stride(1) == 1 and a.stride(0) % 8 == 0 and a.data_ptr() % 16 == 0:
        return a
    return a.contiguous()


def k5a(a, r, g, p, xp, rl, lmax: int, mmax: int) -> torch.Tensor:
    """K5a on CUDA tensors, its plain version on CPU tensors."""
    if not xp.is_cuda:
        return k5a_plain(a, r, g, p, xp, rl, lmax, mmax)
    E, _, C = xp.shape
    out = xp.new_empty(E, 1 + sum(out_rows(lmax, mmax)), C)
    _launch(0, lmax, mmax, dict(a=a, r=r, g=g, p=p, xp=xp, rl=rl), dict(dout=out))
    return out


def k5b(a, r, g, p, xp, rl, dout, lmax: int, mmax: int, need=(True,) * 6) -> tuple:
    """K5b on CUDA tensors, its plain version on CPU tensors: (da, dr, dg,
    dp, dxp, drl), each None where ``need`` (one flag each) is false or,
    for dp, without p."""
    need = [n and (i != 3 or p is not None) for i, n in enumerate(need)]
    if not xp.is_cuda:
        return tuple(t if n else None
                     for t, n in zip(k5b_plain(a, r, g, p, xp, rl, dout, lmax, mmax), need))
    shapes = (r.shape, r.shape, r.shape, r.shape, xp.shape, rl.shape)
    outs = dict(zip(OUT_SLOTS, (xp.new_empty(s) if n else None for s, n in zip(shapes, need))))
    _launch(1, lmax, mmax, dict(a=a, r=r, g=g, p=p, xp=xp, rl=rl, dout=dout), outs)
    return tuple(outs[k] for k in OUT_SLOTS[:6])


def k5c(a, r, g, p, xp, rl, dout, ga, gr, gg, gp, gxp, grl, lmax: int, mmax: int,
        need=(True,) * 7) -> tuple:
    """K5c on CUDA tensors, its plain version on CPU tensors: the gradients
    of (a, r, g, p, xp, rl, dout), each None where ``need`` is false or,
    for p, without p; a cotangent that is None reads as zero."""
    need = [n and (i != 3 or p is not None) for i, n in enumerate(need)]
    if not xp.is_cuda:
        got = k5c_plain(a, r, g, p, xp, rl, dout, ga, gr, gg, gp, gxp, grl, lmax, mmax)
        return tuple(t if n else None for t, n in zip(got, need))
    shapes = (r.shape, r.shape, r.shape, r.shape, xp.shape, rl.shape, dout.shape)
    outs = dict(zip(OUT_SLOTS, (xp.new_empty(s) if n else None for s, n in zip(shapes, need))))
    _launch(2, lmax, mmax, dict(a=a, r=r, g=g, p=p, xp=xp, rl=rl, dout=dout, ga=ga, gr=gr,
                                gg=gg, gp=gp, gxp=gxp, grl=grl), outs)
    return tuple(outs[k] for k in OUT_SLOTS)


def _contiguous(t):
    return t.contiguous() if t is not None else None


class _GataValueGradOfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geom, need, a, r, g, p, xp, rl, dout, ga, gr, gg, gp, gxp, grl):
        return k5c(a, r, g, p, xp, rl, dout, ga, gr, gg, gp, gxp, grl, *geom, need=need)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "third-order derivatives of the fused GATA value activation are not "
            "supported: the chain ends at K5c"
        )


class _GataValueBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geom, need, a, r, g, p, xp, rl, dout):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, r, g, p, xp, rl, dout)
        ctx.geom = geom
        return k5b(a, r, g, p, xp, rl, dout, *geom, need=need)

    @staticmethod
    def backward(ctx, ga, gr, gg, gp, gxp, grl):
        a, r, g, p, xp, rl, dout = ctx.saved_tensors
        got = _GataValueGradOfGrad.apply(
            ctx.geom, tuple(ctx.needs_input_grad[2:]), a, r, g, p, xp, rl, dout,
            *(_contiguous(t) for t in (ga, gr, gg, gp, gxp, grl)))
        return (None, None, *got)


class _GataValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, geom, a, r, g, p, xp, rl):
        ctx.save_for_backward(a, r, g, p, xp, rl)
        ctx.geom = geom
        return k5a(a, r, g, p, xp, rl, *geom)

    @staticmethod
    def backward(ctx, dout):
        a, r, g, p, xp, rl = ctx.saved_tensors
        got = _GataValueBackward.apply(ctx.geom, tuple(ctx.needs_input_grad[1:]), a, r, g, p,
                                       xp, rl, dout.contiguous())
        return (None, *got)


def gata_value(a, r, g, p, xp, rl, lmax: int, mmax: int) -> torch.Tensor:
    """The fused value activation: a, r, g, p [E, (1 + 2 lmax) C] (p None
    where absent), xp [E, lmax (lmax + 2), C], rl [E, lmax (lmax + 2)], all
    of one dtype; returns [E, K_red, C] (module doc)."""
    _check(a, r, g, p, xp, rl, lmax, mmax)
    a = _aligned(a) if a.is_cuda else a
    return _GataValue.apply((lmax, mmax), a, r.contiguous(), g.contiguous(), _contiguous(p),
                            xp.contiguous(), rl.contiguous())
