"""The port's hand-written kernels on the card, against their plain versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (as on a CPU-only machine).  This file imports no JAX, so on a GPU
machine without JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: float32 max abs error <= 1e-5 max|plain| (the order of the f32
sums differs), bfloat16 <= 1e-2 max|plain| (one bf16 rounding of the output
is 2^-8 relative).  The training step on the card against the CPU: loss
1e-4 relative, gradients 1e-3 relative L2; parameters and EMA after the
step, from the card's gradients on both sides, 1e-2 lr absolute.
"""

import ctypes

import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import rotation as rot
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import build
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import edge_rotate
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import gata_value as gv
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import rotate as k4
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
    rotate_dense as rd,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.activations import (
    s2_activation,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.so3_layers import SO2Conv
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import s2act
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import so2conv as k3
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.irreps import layout
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.s2grid import s2grid

pytestmark = pytest.mark.cuda
LIMIT = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= LIMIT[dtype] * max(want.float().abs().max().item(), 1e-30), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", rd.KINDS)
@pytest.mark.parametrize("lm", [(2, 1), (4, 2), (4, 4)], ids=str)
def test_rotate_kernel_matches_plain(dev, lm, kind, dtype):
    lmax, mmax = lm
    g = torch.Generator(device=dev).manual_seed(0)
    E, C = 301, 40
    w = rd.compute_wigner_dense(lmax, mmax, torch.randn(E, 3, generator=g, device=dev))
    v = {"to": w.v_to, "from": w.v_from_res, "to_m0": w.v_to_m0,
         "from_m0": w.v_from_m0}[kind]
    n_in = rd._pair_info(lmax, mmax)["n_in"][kind]
    x = torch.randn(E, n_in, C, generator=g, device=dev).to(dtype)
    before = rd.launches[kind]
    got = rd.pairs_apply(x, v, lmax, mmax, kind)
    assert rd.launches[kind] == before + 1
    _close(got, rd.pairs_apply_plain(x, v, lmax, mmax, kind), dtype)


def test_rotate_autograd_runs_the_adjoint_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    E, C = 200, 32
    vec = torch.randn(E, 3, generator=g, device=dev)
    x = torch.randn(E, 25, C, generator=g, device=dev)

    def loss(x, w):
        y = rd.rotate_from_edge_dense(w, rd.rotate_to_edge_dense(w, x))
        return y.square().sum() + rd.rotate_to_edge_m0_dense(w, x).square().sum()

    xg = x.clone().requires_grad_(True)
    xc = x.cpu().requires_grad_(True)
    n = dict(rd.launches)
    (gx,) = torch.autograd.grad(loss(xg, rd.compute_wigner_dense(4, 2, vec)), xg)
    # forward: to, from, to_m0; backward: their adjoints from, to, from_m0
    assert {k: rd.launches[k] - n[k] for k in rd.KINDS} == {
        "to": 2, "from": 2, "to_m0": 1, "from_m0": 1}
    (gxc,) = torch.autograd.grad(loss(xc, rd.compute_wigner_dense(4, 2, vec.cpu())), xc)
    torch.testing.assert_close(gx.cpu(), gxc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", k4.KINDS)
@pytest.mark.parametrize("lm", k4.INSTANCES, ids=str)
def test_factored_rotate_kernel_matches_plain(dev, lm, kind, dtype):
    """K4 against rot_plain on a ragged edge tile (E = 301, 40 channels)."""
    lmax, mmax = lm
    g = torch.Generator(device=dev).manual_seed(6)
    E, C = 301, 40
    w = rot.compute_wigner(lmax, torch.randn(E, 3, generator=g, device=dev))
    tabs = k4.tables(w, lmax, mmax, kind)[0]
    x = torch.randn(E, tabs[0].shape[1], C, generator=g, device=dev).to(dtype)
    before = k4.launches[kind]
    got = k4.rot(x, tabs, lmax, mmax, kind)
    assert k4.launches[kind] == before + 1
    _close(got, k4.rot_plain(x, tabs), dtype)


def test_factored_rotate_grad_of_grad_on_the_card_matches_the_cpu(dev):
    """to / to_m0 / from and, in the backward passes, their adjoints:
    every kind of K4 launches, and the second derivative agrees with the
    CPU's plain path."""
    g = torch.Generator(device=dev).manual_seed(7)
    E, C = 333, 64
    vec = torch.randn(E, 3, generator=g, device=dev)
    x = torch.randn(E, 49, C, generator=g, device=dev)
    lay = layout(6, 2)

    def gradgrad(x, vec):
        w = rot.compute_wigner(6, vec)
        x = x.clone().requires_grad_(True)
        h = torch.nn.functional.silu(rot.rotate_to_edge(w, x, lay))
        e = (rot.rotate_from_edge(w, h, lay) ** 2).sum() + \
            (rot.rotate_to_edge_m0(w, x, lay) ** 3).sum()
        (gx,) = torch.autograd.grad(e, x, create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), x)[0]

    n = dict(k4.launches)
    got = gradgrad(x, vec)
    assert all(k4.launches[k] > n[k] for k in k4.KINDS), k4.launches
    want = gradgrad(x.cpu(), vec.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


NARROW = [(torch.bfloat16, 16), (torch.float32, 8)]   # the narrowest 16-byte widths


def _ragged_edges(te: int) -> list[int]:
    """Edge counts around the kernels' tile: one edge, a tile less one,
    a tile plus one (a ragged last tile) and many tiles."""
    return sorted({1, max(te - 1, 1), te + 1, 1001})


@pytest.mark.parametrize("dtype,C", NARROW, ids=["bf16_C16", "f32_C8"])
@pytest.mark.parametrize("kind", rd.KINDS)
@pytest.mark.parametrize("lm", rd.INSTANCES, ids=str)
def test_rotate_kernel_ragged_and_narrow(dev, lm, kind, dtype, C):
    """K1 on every instance at the narrowest widths, with edge counts
    around its tile (``edge_rotate.pairs_plan``)."""
    lmax, mmax = lm
    g = torch.Generator(device=dev).manual_seed(8)
    te = edge_rotate.pairs_plan(torch.finfo(dtype).bits // 8, lmax, mmax, kind, C).te
    for E in _ragged_edges(te):
        w = rd.compute_wigner_dense(lmax, mmax, torch.randn(E, 3, generator=g, device=dev))
        v = {"to": w.v_to, "from": w.v_from_res, "to_m0": w.v_to_m0,
             "from_m0": w.v_from_m0}[kind]
        n_in = rd._pair_info(lmax, mmax)["n_in"][kind]
        x = torch.randn(E, n_in, C, generator=g, device=dev).to(dtype)
        _close(rd.pairs_apply(x, v, lmax, mmax, kind), rd.pairs_apply_plain(x, v, lmax, mmax, kind),
               dtype)


@pytest.mark.parametrize("dtype,C", NARROW, ids=["bf16_C16", "f32_C8"])
@pytest.mark.parametrize("kind", k4.KINDS)
@pytest.mark.parametrize("lm", k4.INSTANCES, ids=str)
def test_factored_rotate_kernel_ragged_and_narrow(dev, lm, kind, dtype, C):
    """K4 on every instance at the narrowest widths, with edge counts
    around its tile (``edge_rotate.rot_plan``)."""
    lmax, mmax = lm
    g = torch.Generator(device=dev).manual_seed(9)
    te = edge_rotate.rot_plan(torch.finfo(dtype).bits // 8, lmax, mmax, kind, C).te
    for E in _ragged_edges(te):
        w = rot.compute_wigner(lmax, torch.randn(E, 3, generator=g, device=dev))
        tabs = k4.tables(w, lmax, mmax, kind)[0]
        x = torch.randn(E, tabs[0].shape[1], C, generator=g, device=dev).to(dtype)
        _close(k4.rot(x, tabs, lmax, mmax, kind), k4.rot_plain(x, tabs), dtype)


@pytest.mark.parametrize("name", ["rotate_dense", "rotate"])
def test_tile_plan_matches_the_library(dev, name):
    """ops/cuda/edge_rotate.py's mirror of the plan equals the library's
    (csrc/edge_rotate.cuh:plan), for every instance, kind and dtype over
    narrow, main-path and wide channel counts (the widest cut into chunks)."""
    lib = build.library(name)
    query = lib.etq_rotate_pairs_plan if name == "rotate_dense" else lib.etq_rotate_plan
    mirror = edge_rotate.pairs_plan if name == "rotate_dense" else edge_rotate.rot_plan
    out = (ctypes.c_int * 4)()
    for lmax, mmax in (rd.INSTANCES if name == "rotate_dense" else k4.INSTANCES):
        for k, kind in enumerate(rd.KINDS):
            for dt, elt in ((0, 4), (1, 2)):
                for C in (8, 16, 40, 128, 256, 512, 2048, 8192):
                    if C % (16 // elt):
                        continue
                    assert query(dt, k, lmax, mmax, C, ctypes.byref(out)) == 0
                    p = mirror(elt, lmax, mmax, kind, C)
                    assert tuple(out) == (p.te, p.ct, p.stages, p.smem), (lmax, mmax, kind, elt, C)


def test_narrow_bf16_factored_rotate_raises(dev):
    """K4 moves 16 bytes per access: a bf16 width that is not a multiple of
    8 channels is refused by the wrapper, not run."""
    w = rot.compute_wigner(4, torch.randn(5, 3, device=dev))
    tabs = k4.tables(w, 4, 2, "to")[0]
    with pytest.raises(ValueError, match="multiple of 8"):
        k4.rot(torch.zeros(5, 25, 12, device=dev, dtype=torch.bfloat16), tabs, 4, 2, "to")


# every K with an instance in csrc/s2act.cu: K = 4, 7, 9, 14, 16, 19, 25, 29, 49
# (K = 19 also on the flagship's resolution-18 grid, P = 324)
S2_INSTANCES = [(1, 1, None), (2, 1, None), (2, 2, None), (3, 2, None), (3, 3, None),
                (4, 2, None), (4, 2, 18), (4, 4, 18), (6, 2, None), (6, 6, None)]
# ragged tiles: one node, narrow widths, N C not a multiple of the 16- or
# 32-channel column tile, and the widest main-path width
S2_RAGGED = [(1, 8), (1, 24), (37, 24), (37, 136), (3, 128), (2, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("backward", [False, True], ids=["k1", "k2"])
@pytest.mark.parametrize("key", S2_INSTANCES, ids=str)
def test_s2act_kernel_matches_plain(dev, key, backward, dtype):
    """K2a / K2b on the tensor cores against the plain version at every K
    instance and ragged tile, each launch counted under its (kernel, K)."""
    grid = s2grid(*key)
    A, F = grid.tables("cuda")
    K = A.shape[1]
    g = torch.Generator(device=dev).manual_seed(2)
    name = "k2" if backward else "k1"
    for N, C in S2_RAGGED:
        x = torch.randn(N, K, C, generator=g, device=dev).to(dtype)
        do = torch.randn(N, K, C, generator=g, device=dev).to(dtype)
        before = s2act.launches_by_k[(name, K)]
        if backward:
            got, want = s2act.k2(x, do, grid), s2act.k2_plain(x, do, A, F)
        else:
            got, want = s2act.k1(x, grid), s2act.k1_plain(x, A, F)
        assert s2act.launches_by_k[(name, K)] == before + 1
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("key", S2_INSTANCES, ids=str)
def test_s2act_grad_of_grad_kernel_matches_plain(dev, key, dtype):
    """K2c on the tensor cores: both outputs against k3_plain at every K
    instance and ragged tile, each launch counted under its K."""
    grid = s2grid(*key)
    A, F = grid.tables("cuda")
    K = A.shape[1]
    g = torch.Generator(device=dev).manual_seed(4)
    for N, C in S2_RAGGED:
        x, do, ddx = (torch.randn(N, K, C, generator=g, device=dev).to(dtype) for _ in range(3))
        before = s2act.launches_by_k[("k3", K)]
        got = s2act.k3(x, do, ddx, grid)
        assert s2act.launches_by_k[("k3", K)] == before + 1
        for a, b in zip(got, s2act.k3_plain(x, do, ddx, A, F)):
            _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_s2act_grad_of_grad_at_the_baseline_edge_site(dev, dtype):
    """K2c at K = 19 on the flagship's resolution-18 grid (P = 324) at the
    MatPES baseline's edge site [9920, 19, 128], both outputs against
    k3_plain, the launch counted under K = 19."""
    grid = s2grid(4, 2, 18)
    A, F = grid.tables("cuda")
    assert A.shape == (324, 19)
    g = torch.Generator(device=dev).manual_seed(19)
    x, do, ddx = (torch.randn(9920, 19, 128, generator=g, device=dev).to(dtype)
                  for _ in range(3))
    before = s2act.launches_by_k[("k3", 19)]
    got = s2act.k3(x, do, ddx, grid)
    assert s2act.launches_by_k[("k3", 19)] == before + 1
    for a, b in zip(got, s2act.k3_plain(x, do, ddx, A, F)):
        _close(a, b, dtype)


def test_s2act_double_backward_on_the_card_runs_k3(dev):
    """create_graph through the fused activation: the outer backward
    launches K2c once and agrees with the CPU's plain path."""
    grid = s2grid(4, 4, 12)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(21, 25, 64, generator=g, device=dev)

    def gradgrad(x):
        x = x.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(s2act.s2act_fused(x, grid).square().sum(), x,
                                    create_graph=True)
        return torch.autograd.grad(gx.square().sum(), x)[0]

    before = s2act.launches["k3"]
    got = gradgrad(x)
    assert s2act.launches["k3"] == before + 1
    torch.testing.assert_close(got.cpu(), gradgrad(x.cpu()), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("key", [(4, 4, 18), (6, 6, None)], ids=str)
def test_s2act_chain_on_the_card_matches_the_cpu(dev, key, dtype):
    """First order (K2a, then K2b) and grad-of-grad (K2b's backward, K2c)
    through the autograd chain on the card against the CPU's plain chain
    from the same inputs.  f32: 1e-4 max|CPU| (three kernels in a row, each
    held to 1e-5); bf16: first order 2e-2, second 3e-2 of max|CPU| (each
    bf16 stage rounds its output, and a one-ulp difference in the forward
    carries into the backward)."""
    grid = s2grid(*key)
    K = grid.to_grid_np.shape[1]
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(19, K, 40, generator=g, device=dev).to(dtype)

    def chain(x):
        x = x.clone().requires_grad_(True)
        y = s2act.s2act_fused(x, grid)
        (gx,) = torch.autograd.grad(0.5 * y.float().square().sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad(gx.float().square().sum(), x)
        return gx.detach(), gg

    before = dict(s2act.launches)
    got = chain(x)
    # K2a; K2b for gx; K2c, and K2b again for the part through dout = y(x)
    assert {k: s2act.launches[k] - before[k] for k in before} == {"k1": 1, "k2": 2, "k3": 1}
    want = chain(x.cpu())
    limits = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 3e-2)
    for a, b, lim in zip(got, want, limits):
        err = (a.float().cpu() - b.float()).abs().max().item()
        assert err <= lim * b.float().abs().max().item(), err


def test_s2act_wrapper_refuses_tables_over_a_block(dev):
    """A grid whose float32 tables exceed a block's 227 KB (resolution 24
    at lmax 4) raises before any launch of K2b or K2c; nothing falls back."""
    grid = s2grid(4, 4, 24)
    x = torch.zeros(2, 25, 16, device=dev)
    before = dict(s2act.launches)
    with pytest.raises(ValueError, match="shared memory"):
        s2act.k2(x, x, grid)
    with pytest.raises(ValueError, match="shared memory"):
        s2act.k3(x, x, x, grid)
    assert s2act.launches == before


def test_narrow_s2_site_on_the_card_launches_the_kernel(dev):
    """A 32-channel S2 site on the card runs K2a and K2b, not the tensor ops."""
    grid = s2grid(4, 4, 12)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(21, 25, 32, generator=g, device=dev, requires_grad=True)
    before = dict(s2act.launches)
    y = s2_activation(x, grid)
    assert s2act.launches["k1"] == before["k1"] + 1
    (gx,) = torch.autograd.grad(y.square().sum(), x)
    assert s2act.launches["k2"] == before["k2"] + 1
    xc = x.detach().cpu().requires_grad_(True)
    yc = s2_activation(xc, grid)
    (gxc,) = torch.autograd.grad(yc.square().sum(), xc)
    _close(y.detach(), yc.to(dev), torch.float32)
    torch.testing.assert_close(gx.cpu(), gxc, rtol=1e-4, atol=1e-4)


def _k3_weights(lmax, mmax, cin, cout, extra, g, dev, dtype):
    return [(torch.randn(len(r) * cin, (extra if i == 0 else 0) + len(r) * cout,
                         generator=g, device=dev) / (len(r) * cin) ** 0.5).to(dtype)
            for i, r in enumerate(k3._row_maps(lmax, mmax))]


# (lmax, mmax, Cin, Cout, extra): a narrow site (group depths not multiples
# of a 32-deep stage), QM9's conv 1 and conv 2, OC20's width (lmax 6 / mmax
# 2: 7 / 12 / 10 rows per group)
K3_SITES = [(2, 1, 40, 24, 16), (4, 2, 256, 128, 384), (4, 2, 128, 128, 0),
            (6, 2, 128, 128, 0)]
# ragged edge counts: 301 (not a multiple of the 128-edge tile), 129 (a
# single edge in the last tile)
K3_EDGES = [301, 129]


@pytest.mark.parametrize("n_edges", K3_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("site", K3_SITES, ids=str)
def test_so2conv_kernels_match_plain(dev, site, dtype, n_edges):
    """K3-fwd and K3-adj at a ragged edge count."""
    lmax, mmax, cin, cout, extra = site
    g = torch.Generator(device=dev).manual_seed(6)
    K = sum(map(len, k3._row_maps(lmax, mmax)))
    ws = _k3_weights(lmax, mmax, cin, cout, extra, g, dev, dtype)
    x = torch.randn(n_edges, K, cin, generator=g, device=dev).to(dtype)
    dy = torch.randn(n_edges, K, cout, generator=g, device=dev).to(dtype)
    dex = torch.randn(n_edges, extra, generator=g, device=dev).to(dtype) if extra else None
    before = dict(k3.launches)
    y, ex = k3.fwd(x, ws, lmax, mmax, cout, extra)
    dx = k3.adj(dy, dex, ws, lmax, mmax, cin)
    assert (k3.launches["fwd"], k3.launches["adj"]) == (before["fwd"] + 1, before["adj"] + 1)
    y_ref, ex_ref = k3.fwd_plain(x, ws, lmax, mmax, cout, extra)
    _close(y, y_ref, dtype)
    if extra:
        _close(ex, ex_ref, dtype)
    _close(dx, k3.adj_plain(dy, dex, ws, lmax, mmax, cin), dtype)


@pytest.mark.parametrize("adjoint", [False, True], ids=["fwd", "adj"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_so2conv_b_operands_kernel_matches_plain(dev, dtype, adjoint):
    """K3's B operands (the weight transposed for the forward, split into
    TF32 parts in f32) from the card's kernel, bit for bit as the plain
    version makes them."""
    g = torch.Generator(device=dev).manual_seed(8)
    ws = _k3_weights(2, 1, 40, 24, 16, g, dev, dtype)
    before = k3.launches["b_operands"]
    hi, lo = k3.b_operands(ws, adjoint)
    hi_ref, lo_ref = k3.b_operands_plain(ws, adjoint)
    launched = k3.launches["b_operands"] - before
    assert launched == (0 if adjoint and dtype == torch.bfloat16 else len(ws))
    torch.cuda.synchronize()
    for got, want in zip(hi + (lo or []), hi_ref + (lo_ref or [])):
        assert got.shape == want.shape and torch.equal(got, want)


# K3-dW at the QM9 cell's E_pad and a batch's live (real) rows, and at the
# narrow sites of K3_SITES with a ragged edge count
K3_DW_CASES = ([((4, 2, 256, 128, 384), 59520, live) for live in (17952, None)]
               + [((4, 2, 128, 128, 0), 59520, live) for live in (17952, None)]
               + [((2, 1, 40, 24, 16), 301, 130), ((6, 2, 128, 128, 0), 129, None)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", K3_DW_CASES, ids=str)
def test_so2conv_dw_kernel_matches_plain(dev, case, dtype):
    """K3-dW (one call: the kernel and its reduce) against dws_plain over
    the same rows [0, live), with the rows past ``live`` not zero (the
    kernel must not read them); the same bits on a second call; one
    ``launches["dw"]`` a call; (live, E) added to the row counter."""
    (lmax, mmax, cin, cout, extra), E, live = case
    g = torch.Generator(device=dev).manual_seed(9)
    K = sum(map(len, k3._row_maps(lmax, mmax)))
    x = torch.randn(E, K, cin, generator=g, device=dev).to(dtype)
    y = torch.randn(E, K, cout, generator=g, device=dev).to(dtype)
    ye = torch.randn(E, extra, generator=g, device=dev).to(dtype) if extra else None
    lv = None if live is None else torch.tensor(live, dtype=torch.int32, device=dev)
    rows0 = k3.dw_rows(dev).clone()
    before = k3.launches["dw"]
    got = k3.dws(x, y, ye, lmax, mmax, lv)
    assert k3.launches["dw"] == before + 1
    again = k3.dws(x, y, ye, lmax, mmax, lv)
    want = k3.dws_plain(x, y, ye, lmax, mmax, live)
    for a, b, w in zip(got, again, want):
        assert a.dtype == dtype and a.shape == w.shape
        assert torch.equal(a, b)
        _close(a, w, dtype)
    counted = (k3.dw_rows(dev) - rows0).tolist()
    assert counted == [2 * (E if live is None else live), 2 * E], counted


def test_so2conv_grad_of_grad_on_the_card_matches_the_cpu(dev):
    """SO2Conv(conv_fused=True) with radial weights: the param gradient of
    |dL/dx|^2 on the card (K3-fwd and K3-adj twice each) against the CPU."""
    lay = layout(4, 2)
    torch.manual_seed(7)
    conv = SO2Conv(lay, 64, 32, extra_m0=32, rad_channels=(16, 16), conv_fused=True)
    with torch.no_grad():
        for p in conv.parameters():
            p.normal_(0.0, 0.2)
    x = torch.randn(150, 19, 64)
    s = torch.randn(150, 16)

    def run(device):
        m = SO2Conv(lay, 64, 32, extra_m0=32, rad_channels=(16, 16), conv_fused=True)
        m.load_state_dict(conv.state_dict())
        m.to(device)
        xx = x.to(device).requires_grad_(True)
        y, ex = m(xx, s.to(device))
        (gx,) = torch.autograd.grad(y.square().sum() + ex.square().sum(), xx,
                                    create_graph=True)
        gx.square().sum().backward()
        return {n: p.grad.cpu() for n, p in m.named_parameters()}

    before = dict(k3.launches)
    got = run(dev)
    assert (k3.launches["fwd"] - before["fwd"], k3.launches["adj"] - before["adj"]) == (2, 2)
    assert k3.launches["dw"] > before["dw"]   # every weight gradient through K3-dW
    want = run("cpu")
    num = sum(float((got[k] - want[k]).double().square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    assert (num / den) ** 0.5 <= 1e-4


def test_model_on_the_card_matches_the_cpu(dev):
    """A small model whose FFN site (128 channels) takes K2 and whose
    rotations take K1: the card against the CPU plain path."""
    cfg = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
               attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=128,
               lmax=4, mmax=2, grid_resolution=12, edge_channels=16, num_rbf=32,
               cutoff=5.0)
    model = init_weights(EquiformerV2MatPES(**cfg), torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(0)
    structs = []
    for n in (6, 9):
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
        structs.append(dict(atomic_numbers=rng.integers(1, 80, size=n).astype(np.int32),
                            positions=(rng.uniform(size=(n, 3)) @ cell).astype(np.float32),
                            cell=cell))
    before = {**{f"r.{k}": c for k, c in rd.launches.items()},
              **{f"s.{k}": c for k, c in s2act.launches.items()}}
    gpu = Predictor(model, state, 5.0, 8, device="cuda").predict_batch(structs)
    after = {**{f"r.{k}": c for k, c in rd.launches.items()},
             **{f"s.{k}": c for k, c in s2act.launches.items()}}
    # K2c is the grad-of-grad kernel: serving never runs it
    assert all(after[k] > before[k] for k in before if k != "s.k3"), (before, after)
    cpu = Predictor(EquiformerV2MatPES(**cfg), state, 5.0, 8,
                    device="cpu").predict_batch(structs)
    np.testing.assert_allclose(gpu["energy"], cpu["energy"], rtol=1e-4)
    for a, b in zip(gpu["forces"], cpu["forces"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * max(1.0, np.abs(b).max()))


def test_training_step_on_the_card_matches_the_cpu(dev):
    """One float32 force-training step of a small model whose rotations take
    K1 and whose S2 sites take K2a / K2b / K2c: loss and gradients on the
    card against the CPU plain path, and the card's updated parameters and
    EMA against the CPU's optimizer applied to the card's gradients."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        ema_update,
        make_matpes_train_step,
    )

    cfg = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
               attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=128,
               lmax=4, mmax=2, grid_resolution=12, edge_channels=16, num_rbf=32,
               cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
    weights = init_weights(EquiformerV2MatPES(**cfg), torch.Generator().manual_seed(0))
    weights = {k: v.clone() for k, v in weights.state_dict().items()}
    pb = collate(labelled_structures(np.random.default_rng(0), 2, 9), 5.0, 8, 32, 256,
                 fixed_degree=True)
    lr, out = 1e-3, {}

    def train_state(d):
        model = EquiformerV2MatPES(**cfg)
        model.load_state_dict(weights)
        model.to(d)
        return create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                      lambda s: lr, 1e-3, 1.0))

    for d in ("cuda", "cpu"):
        state = train_state(d)
        before = {**{f"r.{k}": c for k, c in rd.launches.items()},
                  **{f"s.{k}": c for k, c in s2act.launches.items()}}
        loss, _ = make_matpes_train_step(state)(as_tensors(pb, d))
        after = {**{f"r.{k}": c for k, c in rd.launches.items()},
                 **{f"s.{k}": c for k, c in s2act.launches.items()}}
        if d == "cuda":
            assert all(after[k] > before[k] for k in before), (before, after)
        out[d] = (float(loss), {n: p.grad.cpu() for n, p in state.model.named_parameters()},
                  {n: p.detach().cpu() for n, p in state.model.named_parameters()},
                  {n: e.cpu() for n, e in state.ema.items()})
    (lg, gg, pg, eg), (lc, gc, _, _) = out["cuda"], out["cpu"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    num = sum(float(((gg[k] - gc[k]) ** 2).sum()) for k in gc)
    den = sum(float((gc[k] ** 2).sum()) for k in gc)
    assert (num / den) ** 0.5 <= 1e-3
    # the update on identical gradients: Adam's first step lr g / (|g| + eps)
    # is sign-like where |g| is near eps, so only the same g holds every
    # entry to 1e-2 lr
    replay = train_state("cpu")
    for n, p in replay.model.named_parameters():
        p.grad = gg[n].clone()
    assert replay.optimizer.step()["accepted"]
    ema_update(replay.ema, replay.model)
    for k, p in replay.model.named_parameters():
        torch.testing.assert_close(pg[k], p.detach(), rtol=0, atol=1e-2 * lr, msg=k)
        torch.testing.assert_close(eg[k], replay.ema[k], rtol=0, atol=1e-2 * lr, msg=k)


def test_stress_step_on_the_card_matches_the_cpu(dev):
    """The loss of a small baseline model (no GATA) with per-graph stress:
    its edge S2 site takes K2a / K2b / K2c at K = 19 and its rotations K1,
    in a grad-of-grad by positions and strain.  Loss 1e-4 relative;
    gradients, forces and stress 1e-3 relative L2, card against the CPU."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    cfg = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
               attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
               lmax=4, mmax=2, grid_resolution=18, edge_channels=16, num_rbf=32,
               cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0, gata=False)
    weights = init_weights(EquiformerV2MatPES(**cfg), torch.Generator().manual_seed(1))
    weights = {k: v.clone() for k, v in weights.state_dict().items()}
    rng = np.random.default_rng(1)
    samples = labelled_structures(rng, 2, 9)
    for smp in samples:
        smp.stress = (rng.normal(size=6) * 0.05).astype(np.float32)
    pb = collate(samples, 5.0, 8, 32, 256,
                 fixed_degree=True)
    out = {}
    for d in ("cuda", "cpu"):
        model = EquiformerV2MatPES(**cfg)
        model.load_state_dict(weights)
        model.to(d).train()
        before = s2act.launches_by_k[("k3", 19)]
        batch = as_tensors(pb, d)
        with full_f32_products():
            outs = matpes_energy_forces(model, batch, create_graph=True, regress_stress=True)
            loss, _ = matpes_loss(outs, batch, 1.0, 1.0, 0.1)
            loss.backward()
        if d == "cuda":
            assert s2act.launches_by_k[("k3", 19)] > before
        out[d] = dict(loss=float(loss.detach()), forces=outs["forces"].detach().cpu(),
                      stress=outs["stress"].detach().cpu(),
                      grads={n: p.grad.cpu() for n, p in model.named_parameters()})
    got, want = out["cuda"], out["cpu"]
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    for key in ("forces", "stress"):
        assert float((got[key] - want[key]).norm() / want[key].norm()) <= 1e-3, key
    num = sum(float(((got["grads"][k] - w) ** 2).sum()) for k, w in want["grads"].items())
    den = sum(float((w ** 2).sum()) for w in want["grads"].values())
    assert (num / den) ** 0.5 <= 1e-3


def test_gata_v1_model_on_the_card_matches_the_cpu(dev):
    """A small GATA v1 model (the registry's ``equiformer_v2_matpes_gata``:
    lmax = mmax = 4, so K1 runs its (4, 4) instance) forward and backward:
    energies, forces and the gradients of a force loss (a grad-of-grad) on
    the card against the CPU plain path."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.registry import (
        make_model,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss,
    )

    cfg = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
               attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=128,
               lmax=4, grid_resolution=12, edge_channels=16, num_rbf=32, cutoff=5.0,
               alpha_drop=0.0, drop_path_rate=0.0)
    weights = init_weights(make_model("equiformer_v2_matpes_gata", **cfg),
                           torch.Generator().manual_seed(0)).state_dict()
    pb = collate(labelled_structures(np.random.default_rng(1), 2, 9), 5.0, 8, 32, 256,
                 fixed_degree=True)
    out = {}
    for d in ("cuda", "cpu"):
        model = make_model("equiformer_v2_matpes_gata", **cfg)
        model.load_state_dict(weights)
        model.to(d)
        before = dict(rd.launches_by_lm)
        outs = matpes_energy_forces(model, as_tensors(pb, d), create_graph=True)
        loss, _ = matpes_loss(outs, as_tensors(pb, d), 1.0, 1.0)
        loss.backward()
        if d == "cuda":
            ran = {k for k, c in rd.launches_by_lm.items() if c > before.get(k, 0)}
            assert ran == {(k, 4, 4) for k in ("to_m0", "from", "to", "from_m0")}, ran
        out[d] = dict(e=outs["energy"].detach().cpu(), f=outs["forces"].detach().cpu(),
                      g={n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                         for n, p in model.named_parameters()})
    g, c = out["cuda"], out["cpu"]
    torch.testing.assert_close(g["e"], c["e"], rtol=1e-4, atol=0)
    assert (g["f"] - c["f"]).abs().max() <= 1e-3 * max(1.0, float(c["f"].abs().max()))
    num = sum(float((g["g"][k] - c["g"][k]).double().square().sum()) for k in c["g"])
    den = sum(float(c["g"][k].double().square().sum()) for k in c["g"])
    assert (num / den) ** 0.5 <= 1e-3


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_deterministic_segment_pair_on_the_card(dev, dt):
    """ops/segment.py's gather / segment-sum pair on CUDA tensors: the same
    bits twice, to the second derivative, and index_select / index_add
    (atomics) within their rounding (f32 1e-5, bf16 2e-2 of the largest)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import segment as seg

    gen = torch.Generator(device=dev).manual_seed(0)
    n, E = 496, 9920
    ids = torch.randint(0, n, (E,), generator=gen, device=dev)
    x = torch.randn(n, 25, 64, generator=gen, device=dev).to(dt)
    u = torch.randn(n, 25, 64, generator=gen, device=dev).to(dt)

    def run(gather):
        w = x.clone().requires_grad_(True)
        y = seg.segment_sum(gather(w).float().square().to(dt), ids, n)
        (g,) = torch.autograd.grad(y.float().sum(), w, create_graph=True)
        (h,) = torch.autograd.grad((g.float() * u.float()).sum(), w)
        return y.detach(), g.detach(), h

    a, b = run(lambda w: seg.gather_nodes(w, ids)), run(lambda w: seg.gather_nodes(w, ids))
    for p, q in zip(a, b):
        assert torch.equal(p, q)
    ref = run(lambda w: w.index_select(0, ids))
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for p, r in zip(a, ref):
        assert (p.float() - r.float()).abs().max() <= tol * r.float().abs().max()


@pytest.mark.parametrize("mode", ["remat", "inner_ckpt"])
def test_remat_step_on_the_card_matches_the_step_without(dev, mode):
    """The float32 force loss of a small model (K1 rotations, K2a-c S2
    sites) with each block rematerialized (``remat``) or the whole energy
    evaluation (``inner_ckpt``): loss and gradients on the card within
    1e-5 (relative, relative L2) of the same step without, and every
    kernel launched inside the recomputes."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    cfg = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
               attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=128,
               lmax=4, mmax=2, grid_resolution=12, edge_channels=16, num_rbf=32,
               cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0, fixed_degree=True,
               uniform_blocks=True)
    model = init_weights(EquiformerV2MatPES(**cfg), torch.Generator().manual_seed(0)).to(dev)
    batch = as_tensors(collate(labelled_structures(np.random.default_rng(0), 2, 9), 5.0, 8,
                               32, 256, fixed_degree=True), dev)
    out = {}
    for on in (False, True):
        model.backbone.remat = on and mode == "remat"
        model.zero_grad(set_to_none=True)
        before = {**{f"r.{k}": c for k, c in rd.launches.items()},
                  **{f"s.{k}": c for k, c in s2act.launches.items()}}
        with full_f32_products():
            outs = matpes_energy_forces(model, batch, create_graph=True,
                                        inner_ckpt=on and mode == "inner_ckpt")
            loss, _ = matpes_loss(outs, batch)
            loss.backward()
        after = {**{f"r.{k}": c for k, c in rd.launches.items()},
                 **{f"s.{k}": c for k, c in s2act.launches.items()}}
        assert all(after[k] > before[k] for k in before), (before, after)
        out[on] = (float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                                          if p.grad is not None})
    (l0, g0), (l1, g1) = out[False], out[True]
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    assert g1.keys() == g0.keys()
    num = sum(float(((g1[k] - g0[k]).double() ** 2).sum()) for k in g0)
    den = sum(float((g0[k].double() ** 2).sum()) for k in g0)
    assert (num / den) ** 0.5 <= 1e-5


# K5 (GATA-V2's value activation): (E, C, lmax, mmax, with p, a's column
# offset).  The flagship training step's edges (64 x 30 atoms, fixed
# degree); a ragged E, not a multiple of a block's 16 (bf16) or 8 (f32)
# edges, with p; the model=2 shard's C with a as a column slice; the small
# test models' C; C = 24, whose 16-byte vectors do not fill a power-of-two
# group of lanes, at lmax = mmax = 3
K5_CASES = [(39680, 128, 4, 2, False, 0), (9923, 128, 4, 2, True, 0),
            (7296, 64, 4, 2, False, 128), (37, 16, 4, 2, True, 8), (501, 24, 3, 3, False, 0)]


def _k5_case(E, C, lmax, mmax, with_p, extra, dtype, dev, seed):
    """The six inputs, dout and the six cotangents of K5b's outputs, in
    ``dtype`` on the card (p's and its cotangent None without p)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S, K1 = 1 + 2 * lmax, lmax * (lmax + 2)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)  # noqa: E731
    base = rnd(E, extra + S * C)
    ins = [base[:, extra:], rnd(E, S * C), rnd(E, S * C), rnd(E, S * C) if with_p else None,
           rnd(E, K1, C), rnd(E, K1)]
    dout = rnd(E, 1 + sum(gv.out_rows(lmax, mmax)), C)
    cots = [rnd(E, S * C), rnd(E, S * C), rnd(E, S * C), rnd(E, S * C) if with_p else None,
            rnd(E, K1, C), rnd(E, K1)]
    return ins, dout, cots


def _f32(ts):
    return [t.float() if t is not None else None for t in ts]


def _close_all(got, want, dtype):
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if y is not None:
            _close(x, y, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", K5_CASES, ids=str)
def test_gata_value_kernels_match_plain(dev, case, dtype):
    """K5a, K5b and K5c against their plain versions (float32, from the same
    inputs), every output, each launch counted."""
    E, C, lmax, mmax, with_p, extra = case
    ins, dout, cots = _k5_case(*case, dtype, dev, seed=22)
    before = dict(gv.launches)
    _close(gv.k5a(*ins, lmax, mmax), gv.k5a_plain(*_f32(ins), lmax, mmax), dtype)
    _close_all(gv.k5b(*ins, dout, lmax, mmax),
               gv.k5b_plain(*_f32(ins), dout.float(), lmax, mmax), dtype)
    _close_all(gv.k5c(*ins, dout, *cots, lmax, mmax),
               gv.k5c_plain(*_f32(ins), dout.float(), *_f32(cots), lmax, mmax), dtype)
    assert {k: gv.launches[k] - before[k] for k in gv.KERNELS} == dict(k5a=1, k5b=1, k5c=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gata_value_kernels_leave_out_what_no_one_needs(dev, dtype):
    """The flagship step's calls: no rl gradient (the edge SH are detached),
    no p; K5c with rl's cotangent absent.  The outputs left out are None,
    the others match the plain versions, and the rows of xp the activation
    drops get zero gradients."""
    lmax, mmax = 4, 2
    ins, dout, cots = _k5_case(9920, 128, lmax, mmax, False, 0, dtype, dev, seed=23)
    cots[5] = None
    need_b = (True, True, True, False, True, False)
    got = gv.k5b(*ins, dout, lmax, mmax, need=need_b)
    want = gv.k5b_plain(*_f32(ins), dout.float(), lmax, mmax)
    _close_all(got, [w if n else None for w, n in zip(want, need_b)], dtype)
    unused = torch.ones(lmax * (lmax + 2), dtype=torch.bool, device=dev)
    for l, w in enumerate(gv.out_rows(lmax, mmax), start=1):
        unused[l * l - 1 : l * l - 1 + w] = False
    assert (got[4][:, unused] == 0).all()
    need_c = (True, True, True, False, True, False, True)
    got = gv.k5c(*ins, dout, *cots, lmax, mmax, need=need_c)
    want = gv.k5c_plain(*_f32(ins), dout.float(), *_f32(cots), lmax, mmax)
    _close_all(got, [w if n else None for w, n in zip(want, need_c)], dtype)
    assert (got[4][:, unused] == 0).all()


def test_gata_value_wrapper_refuses_what_the_kernel_does_not_take(dev):
    ins, _, _ = _k5_case(64, 20, 2, 1, False, 0, torch.float32, dev, seed=24)
    with pytest.raises(ValueError, match="multiple of 8"):
        gv.k5a(*ins, 2, 1)
    ins, _, _ = _k5_case(64, 16, 2, 1, False, 0, torch.float64, dev, seed=24)
    with pytest.raises(TypeError):
        gv.k5a(*ins, 2, 1)


def _flagship_gata(dtype=None):
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import (
        FIXED_DEGREE,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import FLAGSHIP

    kw = dict(compute_dtype=dtype, **FIXED_DEGREE) if dtype is not None else {}
    model = EquiformerV2MatPES(**{**FLAGSHIP, "alpha_drop": 0.0, "drop_path_rate": 0.0}, **kw)
    return init_weights(model, torch.Generator().manual_seed(0)), FLAGSHIP


def _flagship_step_batch(n: int, dev, seed: int = 0):
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import (
        fixed_degree_pads,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )

    pb = collate(labelled_structures(np.random.default_rng(seed), n, 30), 6.0, 20,
                 *fixed_degree_pads([30] * n, 20), fixed_degree=True)
    return as_tensors(pb, dev)


def test_flagship_step_and_mixed_request_launch_k5(dev):
    """The flagship bf16 force-training step launches K5a / K5b / K5c 6 /
    12 / 6 times (one per layer; K5b in the force pass and the loss
    backward), a mixed-size f32 request 6 / 6 / 0: every CUDA call of the
    activation goes through the kernels."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        make_matpes_train_step,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import profiling

    model, _ = _flagship_gata(torch.bfloat16)
    model.to(dev)
    state = create_train_state(model, GuardedAdamW(model.named_parameters(), lambda s: 1e-4,
                                                   1e-3, 1.0))
    step = make_matpes_train_step(state)
    batch = _flagship_step_batch(4, dev)
    before = dict(gv.launches)
    _, m = step(batch)
    torch.cuda.synchronize()
    assert m["accepted"]
    assert {k: gv.launches[k] - before[k] for k in gv.KERNELS} == dict(k5a=6, k5b=12, k5c=6)
    del state, step, model
    model, widths = _flagship_gata()
    pred = Predictor(model, model.state_dict(), widths["cutoff"], 20, device="cuda")
    req = profiling.mixed_structures(np.random.default_rng(0))
    before = dict(gv.launches)
    out = pred.predict_batch(req)
    assert np.isfinite(out["energy"]).all()
    assert {k: gv.launches[k] - before[k] for k in gv.KERNELS} == dict(k5a=6, k5b=6, k5c=0)


def test_bf16_flagship_loss_gradient_repeats_bit_for_bit(dev):
    """Two bf16 loss gradients of the flagship from one state on one batch
    are bit for bit equal: K5a-c, like the segment sums, use no atomics."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        matpes_loss_grad,
    )

    model, _ = _flagship_gata(torch.bfloat16)
    model.to(dev)
    state = create_train_state(model, GuardedAdamW(model.named_parameters(), lambda s: 1e-4,
                                                   1e-3, 1.0))
    loss_grad = matpes_loss_grad(state)
    batch = _flagship_step_batch(8, dev, seed=19)
    runs = []
    for _ in range(3):   # the first call warms up
        before = gv.launches["k5c"]
        loss, _ = loss_grad(batch)
        assert gv.launches["k5c"] == before + 6
        runs.append((float(loss), {n: p.grad.detach().clone()
                                   for n, p in model.named_parameters() if p.grad is not None}))
    (la, ga), (lb, gb) = runs[1:]
    assert ga.keys() == gb.keys()
    assert [n for n in ga if not torch.equal(ga[n], gb[n])] == []
    assert la == lb
