"""The fused GATA-V2 value activation (ops/cuda/gata_value.py) on the CPU.

Its plain path is the autograd chain the kernels K5a-c sit in, with the
plain versions: the forward equals GATAValueActivation's eager arithmetic
bit for bit, K5b's and K5c's formulas are held to finite differences
(``gradcheck`` / ``gradgradcheck`` in float64 over all six inputs), and a
third derivative raises.  The kernels themselves are held to the plain
versions on the card (tests/test_torch_cuda.py).
"""

import pytest
import torch
import torch.nn.functional as F

from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.gata import (
    GATAValueActivation,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import gata_value as gv

LMAX, MMAX, E = 2, 1, 2


def _inputs(C: int, with_p: bool, lmax: int = LMAX, seed: int = 0, extra: int = 0):
    """a (a column slice of [E, extra + S C] when extra), r, g, p, xp, rl,
    float64 leaves that require grad; returns (leaves, the six inputs)."""
    g = torch.Generator().manual_seed(seed)
    S, K1 = 1 + 2 * lmax, lmax * (lmax + 2)
    mk = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).requires_grad_(True)  # noqa: E731
    base = mk(E, extra + S * C)
    r, gg, xp, rl = mk(E, S * C), mk(E, S * C), mk(E, K1, C), mk(E, K1)
    p = mk(E, S * C) if with_p else None
    leaves = [t for t in (base, r, gg, p, xp, rl) if t is not None]
    return leaves, (base[:, extra:], r, gg, p, xp, rl)


def _eager_module(mod: GATAValueActivation, attn_output, t_ij, h_j, X_j, rl_ij, phi_r=None):
    """GATAValueActivation.forward as it was written before the kernels: the
    eager arithmetic after the three linears."""
    C, lmax = mod.C, mod.lmax
    rl_ij = rl_ij.to(attn_output.dtype)
    bias = mod.W_rs(t_ij) * F.silu(mod.gamma_s(h_j))
    if mod.use_phi:
        bias = bias * mod._phi(phi_r)
    combined = attn_output + bias
    out = [F.silu(combined[:, :C])[:, None, :]]
    Xp = mod.xj_proj(X_j)
    offset = 0
    for l in range(1, lmax + 1):
        d = 2 * l + 1
        w = min(d, 2 * mod.mmax + 1)
        Xl = Xp[:, offset : offset + w, :]
        rl = rl_ij[:, offset : offset + w, None]
        offset += d
        od = combined[:, l * C : (l + 1) * C][:, None, :]
        ot = combined[:, (lmax + l) * C : (lmax + l + 1) * C][:, None, :]
        out.append(od * rl + ot * Xl)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("use_phi", [False, True], ids=["no_p", "p"])
@pytest.mark.parametrize("lm", [(2, 1), (3, 3), (4, 2)], ids=str)
def test_plain_path_equals_the_module_s_eager_arithmetic(lm, use_phi, dtype):
    """The module through the new function against its eager arithmetic:
    the same output bits, and the first gradients of every parameter and
    input (the new chain runs K5b's formulas) within rounding."""
    lmax, mmax = lm
    C, sphere, ec, nrbf = 16, 24, 12, 10
    torch.manual_seed(1)
    mod = GATAValueActivation(sphere, C, ec, lmax, mmax, use_phi=use_phi,
                              num_rbf=nrbf).to(dtype)
    S, K1 = 1 + 2 * lmax, lmax * (lmax + 2)
    ins = [torch.randn(E, S * C), torch.randn(E, ec), torch.randn(E, sphere),
           torch.randn(E, K1, sphere), torch.randn(E, K1), torch.randn(E, nrbf)]
    ins = [t.to(dtype).requires_grad_(True) for t in ins]
    leaves = ins + list(mod.parameters())
    got = mod(*ins[:5], ins[5] if use_phi else None)
    want = _eager_module(mod, *ins[:5], ins[5] if use_phi else None)
    assert torch.equal(got, want)
    cot = torch.randn_like(got)
    gg = torch.autograd.grad(got, leaves, cot, allow_unused=True)
    gw = torch.autograd.grad(want, leaves, cot, allow_unused=True)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for a, b in zip(gg, gw):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a - b).abs().max() <= tol * max(1.0, b.abs().max().item())


@pytest.mark.parametrize("strided", [False, True], ids=["a", "a_strided"])
@pytest.mark.parametrize("with_p", [False, True], ids=["no_p", "p"])
@pytest.mark.parametrize("C", [16, 32])
def test_gradcheck_k5b(C, with_p, strided):
    """K5b's formulas (the backward of the plain chain) against finite
    differences, over all six inputs."""
    leaves, _ = _inputs(C, with_p, extra=8 if strided else 0)
    extra = 8 if strided else 0

    def f(*ts):
        base, r, g, *rest = ts
        p = rest.pop(0) if with_p else None
        xp, rl = rest
        return gv.gata_value(base[:, extra:], r, g, p, xp, rl, LMAX, MMAX)

    assert torch.autograd.gradcheck(f, leaves)


@pytest.mark.parametrize("strided", [False, True], ids=["a", "a_strided"])
@pytest.mark.parametrize("with_p", [False, True], ids=["no_p", "p"])
@pytest.mark.parametrize("C", [16, 32])
def test_gradgradcheck_k5c(C, with_p, strided):
    """K5c's formulas (the backward of K5b) against finite differences of
    K5b, over all six inputs and the output's cotangent."""
    leaves, _ = _inputs(C, with_p, seed=3, extra=8 if strided else 0)
    extra = 8 if strided else 0

    def f(*ts):
        base, r, g, *rest = ts
        p = rest.pop(0) if with_p else None
        xp, rl = rest
        return gv.gata_value(base[:, extra:], r, g, p, xp, rl, LMAX, MMAX)

    assert torch.autograd.gradgradcheck(f, leaves)


def test_third_order_raises():
    _, (a, r, g, p, xp, rl) = _inputs(16, True)
    out = gv.gata_value(a, r, g, p, xp, rl, LMAX, MMAX)
    (ga,) = torch.autograd.grad(out.square().sum(), a, create_graph=True)
    (gr,) = torch.autograd.grad(ga.square().sum(), r, create_graph=True)
    with pytest.raises(NotImplementedError, match="third-order"):
        torch.autograd.grad(gr.sum(), a)


def test_unneeded_gradients_are_left_out():
    """rl without grad (the model's detached edge SH) and no p: K5b returns
    None for both, K5c for rl, and the others still match autograd through
    the eager arithmetic, to the second order."""
    leaves, (a, r, g, _, xp, rl) = _inputs(16, False)
    rl = rl.detach()

    def second(fn):
        out = fn(a, r, g, None, xp, rl, LMAX, MMAX)
        first = torch.autograd.grad(out.square().sum(), [a, r, g, xp], create_graph=True)
        return torch.autograd.grad(sum((t * t).sum() for t in first), [a, r, g, xp])

    got = gv.k5b(*(t.detach() for t in (a, r, g)), None, xp.detach(), rl,
                 torch.ones(E, 1 + sum(gv.out_rows(LMAX, MMAX)), 16, dtype=torch.float64),
                 LMAX, MMAX, need=(True, True, True, False, True, False))
    assert got[3] is None and got[5] is None and all(t is not None for t in got[:3])
    for x, y in zip(second(gv.gata_value), second(gv.k5a_plain)):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-12)


def test_unused_xp_rows_get_zero_gradients():
    """The rows of xp past w(l) in each degree feed nothing: K5b's and K5c's
    gradients there are exactly zero."""
    _, (a, r, g, p, xp, rl) = _inputs(16, True)
    out = gv.gata_value(a, r, g, p, xp, rl, LMAX, MMAX)
    (gx,) = torch.autograd.grad(out.square().sum(), xp, create_graph=True)
    (gxx,) = torch.autograd.grad(gx.sum() + out.sum(), xp)
    unused = torch.ones(xp.shape[1], dtype=torch.bool)
    for l, w in enumerate(gv.out_rows(LMAX, MMAX), start=1):
        unused[l * l - 1 : l * l - 1 + w] = False
    assert unused.any()
    assert (gx[:, unused] == 0).all() and (gxx[:, unused] == 0).all()


@pytest.mark.parametrize("bad", ["xp_rows", "rl", "r", "mmax"])
def test_shapes_the_function_refuses(bad):
    _, (a, r, g, p, xp, rl) = _inputs(16, True)
    a, r, g, p, xp, rl = (t.detach() for t in (a, r, g, p, xp, rl))
    lmax, mmax = LMAX, MMAX
    if bad == "xp_rows":
        xp = xp[:, :-1]
    elif bad == "rl":
        rl = rl[:, :-1]
    elif bad == "r":
        r = r[:, :-16]
    else:
        mmax = lmax + 1
    with pytest.raises(ValueError):
        gv.gata_value(a, r, g, p, xp, rl, lmax, mmax)
