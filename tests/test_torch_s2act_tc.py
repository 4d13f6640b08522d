"""K2a / K2b / K2c on the tensor cores (csrc/s2act.cu: ``s2act_tc_kernel``), on the CPU.

The kernel cannot run here, so what surrounds it is tested, for each of the
three kernels (K2a, the activation; K2b, its backward; K2c, the backward of
K2b with its two outputs ddout and dx2):

* the host-side tables (``ops/cuda/s2act.py:tc_tables_plain``) in the
  kernel's shared-memory layout: zero padding, the transposed bf16 copies,
  rows of 4 mod 8 words, and big + small reconstructing each float32 table
  within 2^-22 relative (``tf32_round`` is held against numpy in
  tests/test_torch_so2conv_tf32.py); in float32 the three kernels share
  one set;
* the fragment maps: one warp's registers built lane by lane exactly as the
  kernel indexes x (dout, ddx), the tables and the accumulators (the first
  products' accumulators fed to the second products as their A operand,
  in the order pi = [0, 2, 4, 6, 1, 3, 5, 7] in tf32 and as bf16 pairs in
  bf16), multiplied with the PTX ISA's m16n8k8 / m16n8k16 fragment layouts
  in float64, equal the plain version to 1e-12, every output;
* the arithmetic: the chunked 3xTF32 sum with the rounded per-chunk add
  stays within the kernel's float32 limit, 1e-5 max|ref| of a float64
  reference, at (K, P) = (25, 324), (19, 50) and (49, 210), and a single
  TF32 pass does not; the bf16 route (bf16 tables, f32 accumulation, S / W
  rounded to bf16) agrees with the JAX package's ``s2act_fused``, its
  backward and its grad-of-grad (the double vjp, whose second backward is
  ``_k3``) in bfloat16 (Pallas interpret mode, as
  tests/test_pallas_s2act.py runs it) within 1e-2 max|JAX|, the card's
  bf16 limit: one bf16 rounding is 2^-8 relative, and the two round S at
  different points.

Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.ops import s2grid as js2g
from equivarianttransformermpnn4quantumcomputations_tpu.ops.pallas import s2act as js2a
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import s2act as k2
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda.so2conv import tf32_round
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.s2grid import s2grid

LIMIT = 1e-5   # the kernel's float32 limit, of max|ref|
# the grids of the main paths: flagship / QM9 FFN and head, QM9 edge,
# OC20 node, OC20 edge; and a narrow one
GRIDS = [(4, 4, 18), (4, 4, None), (4, 2, None), (6, 6, None), (6, 2, None), (2, 1, None)]
DTYPES = [torch.float32, torch.bfloat16]


KERNELS = [0, 1, 2]
KERNEL_IDS = ["k2a", "k2b", "k2c"]
# per kernel: the bf16 tables with pairs along k, then those with pairs
# along p (transposed), by name
BF16_TABLES = {0: (("A",), ("F",)), 1: (("A", "F"), ("A",)), 2: (("A", "F"), ("F", "A"))}


def _parts(buf: torch.Tensor, L, dtype, kernel: int) -> list[torch.Tensor]:
    """The tables of a flat buffer, as [rows, elements per row] views."""
    if dtype == torch.float32:
        shapes = [(L.pp, L.spk)] * 4
    else:
        by_k, by_p = BF16_TABLES[kernel]
        shapes = [(L.pp, 2 * L.spk)] * len(by_k) + [(L.kn, 2 * L.skp)] * len(by_p)
    out, off = [], 0
    for r, c in shapes:
        out.append(buf[off: off + r * c].view(r, c))
        off += r * c
    assert off == buf.numel()
    return out


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("key", GRIDS, ids=str)
def test_tables_in_the_kernel_layout(key, dtype, kernel):
    grid = s2grid(*key)
    A, F = grid.tables("cpu")
    P, K = A.shape
    L = k2.tc_layout(K, P, dtype, kernel)
    buf = k2.tc_tables_plain(A, F, dtype, kernel)
    assert buf.dtype == dtype and buf.numel() * buf.element_size() == 4 * L.words
    assert 4 * L.words <= k2.SMEM_LIMIT
    assert L.spk % 8 == 4 and L.skp % 8 == 4 and L.pp % 16 == 0 and L.pp >= P
    assert L.kp >= K and L.kn >= K and L.kp % (8 if dtype == torch.float32 else 16) == 0
    parts = _parts(buf, L, dtype, kernel)
    if dtype == torch.float32:
        # one set for the three kernels, built once
        assert k2.tc_tables(grid, "cpu", dtype, kernel) is k2.tc_tables(grid, "cpu", dtype, True)
        for t, (big, small) in zip((A, F), (parts[:2], parts[2:])):
            for part in (big, small):   # TF32: the 13 low mantissa bits are zero
                assert not torch.any(part.view(torch.int32) & 0x1FFF)
            assert torch.equal(big, tf32_round(big))
            got = (big.double() + small.double())[:P, :K]
            assert torch.all((got - t.double()).abs() <= 2.0 ** -22 * t.double().abs())
            rest = big.clone()
            rest[:P, :K] = 0
            assert not torch.any(rest) and not torch.any(small[P:]) and not torch.any(small[:, K:])
        return
    by_k, by_p = BF16_TABLES[kernel]
    want = [({"A": A, "F": F}[n], False) for n in by_k] + [({"A": A, "F": F}[n], True)
                                                          for n in by_p]
    for part, (t, transposed) in zip(parts, want):
        t = (t.t() if transposed else t).to(dtype)
        assert torch.equal(part[: t.shape[0], : t.shape[1]], t)
        rest = part.clone()
        rest[: t.shape[0], : t.shape[1]] = 0
        assert not torch.any(rest)


def test_an_oversized_grid_is_refused_before_launch():
    """A grid whose f32 tables exceed a block's shared memory (resolution
    24 at lmax 4) is refused by the layout, as the kernel would refuse it."""
    A, _ = s2grid(4, 4, 24).tables("cpu")
    assert 4 * k2.tc_layout(A.shape[1], A.shape[0], torch.float32, True).words > k2.SMEM_LIMIT


# ── one warp, lane by lane, as csrc/s2act.cu indexes it ───────────────────


def _lanes():
    return [(lane >> 2, lane & 3) for lane in range(32)]


def _mma(a_regs, b_regs, a_map, b_map, shape):
    """D = A B from per-lane registers and the PTX fragment maps (float64)."""
    m, n, k = shape
    A, B = np.zeros((m, k)), np.zeros((k, n))
    for lane, (g, t) in enumerate(_lanes()):
        for i, (r, c) in enumerate(a_map(g, t)):
            A[r, c] = a_regs[lane][i]
        for i, (r, c) in enumerate(b_map(g, t)):
            B[r, c] = b_regs[lane][i]
    return A @ B


def _acc_lanes(D):
    """The accumulator's registers per lane: d0, d1 (row g, columns 2t,
    2t + 1), d2, d3 (row g + 8)."""
    return [[D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]
            for g, t in _lanes()]


# PTX fragment maps, one (row, column) per register element
def _a_tf32(g, t):
    return [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]


def _b_tf32(g, t):
    return [(t, g), (t + 4, g)]


def _a_bf16(g, t):   # element pairs, the lower column in the low half
    return [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1),
            (g, 2 * t + 8), (g, 2 * t + 9), (g + 8, 2 * t + 8), (g + 8, 2 * t + 9)]


def _b_bf16(g, t):
    return [(2 * t, g), (2 * t + 1, g), (2 * t + 8, g), (2 * t + 9, g)]


def _silu(g):
    return g / (1.0 + np.exp(-g))


def _dsilu(g):
    s = 1.0 / (1.0 + np.exp(-g))
    return s * (1.0 + g * (1.0 - s))


def _d2silu(g):
    s = 1.0 / (1.0 + np.exp(-g))
    return s * (1.0 - s) * (2.0 + g * (1.0 - 2.0 * s))


# per kernel: the first products (operand, table), and the table of each
# second product (one per output)
FIRST = {0: (("x", "A"),), 1: (("x", "A"), ("dout", "F")),
         2: (("x", "A"), ("ddx", "A"), ("dout", "F"))}
SECOND = {0: ("F",), 1: ("A",), 2: ("F", "A")}


def _weights(kernel: int, first: list[np.ndarray]) -> list[np.ndarray]:
    """The second products' A operands from the first products' values:
    S = silu(G) (K2a), W = silu'(G) H (K2b), W1 = silu'(G) U and
    W2 = silu''(G) H U (K2c)."""
    if kernel == 0:
        return [_silu(first[0])]
    if kernel == 1:
        return [_dsilu(first[0]) * first[1]]
    g, u, h = first
    return [_dsilu(g) * u, _d2silu(g) * h * u]


def _warp_tile(ins, tabs, L, K, C, c0, f32: bool, kernel: int) -> list[np.ndarray]:
    """The outputs [K, C], columns c0 .. c0 + 15 of one node, as the
    kernel's warp computes them (float64, no rounding): ins maps x, dout,
    ddx to [K, C]; tabs: the parts of the table buffer as float64 element
    arrays (bf16: the transposed ones under name + "T")."""
    def xv(src, k, c):
        return src[k, c] if (k < K and c < C) else 0.0

    acc = [[np.zeros((16, 8)) for _ in range(L.kn // 8)] for _ in SECOND[kernel]]
    for p0 in range(0, L.pp, 16):
        ws = []   # per j: per output, the lanes' four values
        for j in range(2):
            first = []
            for name, tname in FIRST[kernel]:
                src, tab = ins[name], tabs[tname]
                D = np.zeros((16, 8))
                if f32:
                    for ks in range(L.kp // 8):
                        a = [[xv(src, 8 * ks + t, c0 + g), xv(src, 8 * ks + t, c0 + g + 8),
                              xv(src, 8 * ks + t + 4, c0 + g), xv(src, 8 * ks + t + 4, c0 + g + 8)]
                             for g, t in _lanes()]
                        b = [[tab[p0 + 8 * j + g, 8 * ks + t], tab[p0 + 8 * j + g, 8 * ks + t + 4]]
                             for g, t in _lanes()]
                        D += _mma(a, b, _a_tf32, _b_tf32, (16, 8, 8))
                else:
                    for ks in range(L.kp // 16):
                        k0 = 16 * ks
                        a = [[xv(src, k0 + c, c0 + r) for r, c in _a_bf16(g, t)]
                             for g, t in _lanes()]
                        # word 8 ks + t (+ 4) of row p0 + 8 j + g: coefficients 2 w, 2 w + 1
                        b = [[tab[p0 + 8 * j + g, 2 * (8 * ks + t) + e] for e in (0, 1)]
                             + [tab[p0 + 8 * j + g, 2 * (8 * ks + t + 4) + e] for e in (0, 1)]
                             for g, t in _lanes()]
                        D += _mma(a, b, _a_bf16, _b_bf16, (16, 8, 16))
                first.append(np.array(_acc_lanes(D)))
            ws.append(_weights(kernel, first))
        for o, tname in enumerate(SECOND[kernel]):
            second = tabs[tname] if f32 else tabs[tname + "T"]
            for nb in range(L.kn // 8):
                if f32:   # depth slot t = point 2t, t + 4 = point 2t + 1: A = (d0, d2, d1, d3)
                    for j in range(2):
                        a = [[w[0], w[2], w[1], w[3]] for w in ws[j][o]]
                        b = [[second[p0 + 8 * j + 2 * t, 8 * nb + g],
                              second[p0 + 8 * j + 2 * t + 1, 8 * nb + g]] for g, t in _lanes()]
                        acc[o][nb] += _mma(a, b, _a_tf32, _b_tf32, (16, 8, 8))
                else:     # a[2j] = (d0, d1) and a[2j + 1] = (d2, d3) of block j
                    a = [list(ws[0][o][lane]) + list(ws[1][o][lane]) for lane in range(32)]
                    # word p0 / 2 + t (+ 4) of row 8 nb + g: points 2 w, 2 w + 1
                    b = [[second[8 * nb + g, 2 * (p0 // 2 + t) + e] for e in (0, 1)]
                         + [second[8 * nb + g, 2 * (p0 // 2 + t + 4) + e] for e in (0, 1)]
                         for g, t in _lanes()]
                    acc[o][nb] += _mma(a, b, _a_bf16, _b_bf16, (16, 8, 16))
    outs = []
    for o in range(len(SECOND[kernel])):
        out = np.zeros((K, C))
        for nb in range(L.kn // 8):
            for lane, (g, t) in enumerate(_lanes()):
                d = _acc_lanes(acc[o][nb])[lane]
                for v, (r, kk) in zip(d, [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                          (g + 8, 2 * t + 1)]):
                    k, c = 8 * nb + kk, c0 + r
                    if k < K and c < C:
                        out[k, c] = v
        outs.append(out)
    return outs


def _plain(kernel: int, ins: dict, A, F) -> list[torch.Tensor]:
    """The plain version's outputs for inputs [1, K, C] by name."""
    x, dout, ddx = ins["x"], ins["dout"], ins["ddx"]
    if kernel == 0:
        return [k2.k1_plain(x, A, F)]
    if kernel == 1:
        return [k2.k2_plain(x, dout, A, F)]
    return list(k2.k3_plain(x, dout, ddx, A, F))


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["tf32", "bf16"])
def test_fragment_maps_compute_the_activation(dtype, kernel):
    """K = 19, P = 50 (Pp 64: padded points), C = 20 (a ragged second
    channel tile): the kernel's index maps give the plain version."""
    A, F = s2grid(4, 2, None).tables("cpu")
    P, K = A.shape
    C = 20
    L = k2.tc_layout(K, P, dtype, kernel)
    parts = [p.double().numpy() for p in _parts(k2.tc_tables_plain(A, F, dtype, kernel),
                                                L, dtype, kernel)]
    if dtype == torch.float32:   # the big parts, exact in float64
        tabs = {"A": parts[0], "F": parts[2]}
        At, Ft = tf32_round(A).double(), tf32_round(F).double()
    else:
        by_k, by_p = BF16_TABLES[kernel]
        tabs = dict(zip(by_k, parts))
        tabs.update(zip((n + "T" for n in by_p), parts[len(by_k):]))
        At, Ft = A.to(dtype).double(), F.to(dtype).double()
    rng = np.random.default_rng(0)
    ins = dict(zip(("x", "dout", "ddx"), rng.standard_normal((3, K, C))))
    tiles = [_warp_tile(ins, tabs, L, K, C, c0, dtype == torch.float32, kernel)
             for c0 in (0, 16)]
    wants = _plain(kernel, {n: torch.as_tensor(v)[None] for n, v in ins.items()}, At, Ft)
    for o, want in enumerate(wants):
        got = np.concatenate([t[o][:, c0: c0 + 16] for t, c0 in zip(tiles, (0, 16))], axis=1)
        want = want[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


# ── the arithmetic ────────────────────────────────────────────────────────


def _columns(K, n_cols, seed):
    """x, dout, ddx [K, n_cols], float32."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((K, n_cols)).astype(np.float32))
                 for _ in range(3))


def _split(t):
    big = tf32_round(t)
    return big, tf32_round(t - big)


def _activation(kernel: int, A, F, ins, prod) -> tuple[list, tuple]:
    """The second products' A operands (as ``_weights``, from the first
    products ``prod(table, operand)``) and their tables."""
    x, dout, ddx = ins
    g = prod(A, x)
    if kernel == 0:
        return [torch.nn.functional.silu(g)], (F,)
    s = torch.sigmoid(g)
    d1 = s * (1.0 + g * (1.0 - s))
    if kernel == 1:
        return [d1 * prod(F, dout)], (A,)
    u, h = prod(A, ddx), prod(F, dout)
    d2 = s * (1.0 - s) * (2.0 + g * (1.0 - 2.0 * s))
    return [d1 * u, d2 * h * u], (F, A)


def _emulate_f32(A, F, ins, kernel: int, passes: int) -> list[torch.Tensor]:
    """The kernel's float32 arithmetic on columns x, dout, ddx [K, M]: TF32
    products exact in float64, each first product rounded to f32 once, the
    SiLU and its derivatives in f32, each second product's 16-point chunks
    summed in float64, rounded to f32 and added to the running f32 sum."""
    def prod(Ma, Mb):   # Ma [r, k] @ Mb [k, M] over the 1 or 3 TF32 passes
        (ah, al), (bh, bl) = _split(Ma), _split(Mb)
        out = ah.double() @ bh.double()
        if passes == 3:
            out = out + ah.double() @ bl.double() + al.double() @ bh.double()
        return out.float()

    ws, tables = _activation(kernel, A, F, ins, prod)
    outs = []
    for w, T in zip(ws, tables):
        acc = torch.zeros(T.shape[1], w.shape[1])
        for p0 in range(0, T.shape[0], 16):
            acc = acc + prod(T[p0: p0 + 16].t().contiguous(), w[p0: p0 + 16])
        outs.append(acc)
    return outs


def _reference(A, F, ins, kernel: int) -> list[torch.Tensor]:
    A, F = A.double(), F.double()
    ws, tables = _activation(kernel, A, F, [t.double() for t in ins], torch.matmul)
    return [T.t() @ w for w, T in zip(ws, tables)]


TF32_CASES = [((4, 4, 18), 25, 324), ((4, 2, None), 19, 50), ((6, 6, None), 49, 210)]


def _tf32_errors(key, kernel, passes) -> list[float]:
    """Each output's max abs error over max|ref|."""
    A, F = s2grid(*key).tables("cpu")
    ins = _columns(A.shape[1], 512, 1)
    got = _emulate_f32(A, F, ins, kernel, passes)
    want = _reference(A, F, ins, kernel)
    return [(a.double() - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want)]


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("key,K,P", TF32_CASES, ids=lambda v: str(v))
def test_three_tf32_passes_stay_within_the_f32_limit(key, K, P, kernel):
    assert s2grid(*key).tables("cpu")[0].shape == (P, K)
    assert max(_tf32_errors(key, kernel, 3)) <= LIMIT


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("key,K,P", TF32_CASES, ids=lambda v: str(v))
def test_one_tf32_pass_misses_the_f32_limit(key, K, P, kernel):
    """Every output misses: each needs the three passes."""
    assert min(_tf32_errors(key, kernel, 1)) > LIMIT


def _emulate_bf16(A, F, ins, kernel: int) -> list[torch.Tensor]:
    """The kernel's bf16 route on x, dout, ddx [N, K, C] (bf16): bf16
    tables, products in f32, SiLU and its derivatives in f32, S / W / W1 /
    W2 rounded to bf16, the outputs too."""
    A, F = A.to(torch.bfloat16).float(), F.to(torch.bfloat16).float()
    ws, tables = _activation(kernel, A, F, [t.float() for t in ins], torch.matmul)
    return [torch.matmul(T.t(), w.to(torch.bfloat16).float()).to(torch.bfloat16)
            for w, T in zip(ws, tables)]


@pytest.mark.parametrize("kernel", KERNELS, ids=KERNEL_IDS)
@pytest.mark.parametrize("key", [(4, 2, None), (4, 4, None)], ids=str)
def test_bf16_route_matches_jax_in_bf16(key, kernel):
    """K2a: ``s2act_fused``; K2b: its vjp; K2c: the vjp of that vjp in x
    and dout, (dx2, ddout), which the JAX package computes with ``_k3``."""
    gj, gt = js2g.s2grid(*key), s2grid(*key)
    A, F = gt.tables("cpu")
    rng = np.random.default_rng(2)
    x32 = rng.standard_normal((12, A.shape[1], 32)).astype(np.float32)
    d32 = rng.standard_normal(x32.shape).astype(np.float32)
    dd32 = rng.standard_normal(x32.shape).astype(np.float32)
    xj, dj, ddj = (jnp.asarray(v, jnp.bfloat16) for v in (x32, d32, dd32))

    def first_order(a, d):
        _, vjp = jax.vjp(lambda z: js2a.s2act_fused(z, gj), a)
        return vjp(d)[0]

    if kernel == 2:
        _, vjp2 = jax.vjp(first_order, xj, dj)
        dx2, ddout = vjp2(ddj)
        refs = [ddout, dx2]
    else:
        refs = [first_order(xj, dj) if kernel else js2a.s2act_fused(xj, gj)]
    ins = [torch.as_tensor(v).to(torch.bfloat16) for v in (x32, d32, dd32)]
    for got, ref in zip(_emulate_bf16(A, F, ins, kernel), refs):
        assert ref.dtype == jnp.bfloat16
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.abs(got.float().numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_k2_medians_reads_phase_3_rows(tmp_path, capsys):
    """utils/k2_medians.py: medians and the parent / change ratio from two
    trees' chip_smoke.py K2 rows (the line format check_k2 prints)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import k2_medians

    def row(f32_dev, bf16_dev):
        return (f"kernel s2act.k1 flagship FFN  [496,25,512] P=324  f32: ms 0.2301, device ms "
                f"{f32_dev}, bound 0.0499 (operations, device 25 %), FFMA bound 0.1228, tables "
                f"25.5 MB from L2, err 4.53e-06 (limit 4.1e-05); bf16: ms 0.0726, device ms "
                f"{bf16_dev}, bound 0.0083 (operations, device 16 %), FFMA bound 0.1228, tables "
                f"6.5 MB from L2, err 1.56e-02 (limit 3.9e-02); plain f32 0.7574; SFU floor "
                f"0.0197; library none  [card]\n")

    logs = {}
    for name, f32_dev, bf16_dev in (("c1", 0.2, 0.05), ("c2", 0.1, 0.07), ("c3", 0.3, 0.06),
                                    ("p1", 0.4, 0.4)):
        logs[name] = tmp_path / name
        logs[name].write_text("other output\n" + row(f32_dev, bf16_dev))
    assert k2_medians.main(["--change", *(str(logs[n]) for n in ("c1", "c2", "c3")),
                            "--parent", str(logs["p1"])]) == 0
    out = capsys.readouterr().out
    assert out.startswith("s2act.k1 flagship FFN [496,25,512] P=324: ")
    assert "f32: events 0.2301, device 0.2000 [0.1000-0.3000] (n=3), parent events 0.2301, " \
           "device 0.4000 (x2.00, n=1), bound 0.0499 (operations, 25 %)" in out
    assert "bf16: events 0.0726, device 0.0600 [0.0500-0.0700] (n=3)" in out
