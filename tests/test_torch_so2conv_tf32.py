"""K3's float32 arithmetic on the tensor cores (3xTF32), emulated on the CPU.

The kernel (csrc/so2conv.cu) splits each float32 operand into a TF32 big
part, ``cvt.rna.tf32.f32(a)``, and a TF32 small part, ``cvt.rna(a - big)``,
and sums three TF32 products per float32 product: big big + big small +
small big.  TF32 products are exact in float32, so the emulation forms them
in float64 with the port's plain versions ``fwd_plain`` / ``adj_plain``
(bilinear in the input and the weight) and rounds the sum once.  At QM9's
conv 1 (lmax 4 / mmax 2, Cin 256, Cout 128, extra 384) with inputs from a
numpy seed, the three-pass sum stays within the kernel's float32 limit,
1e-5 max|plain| of a float64 reference; a single TF32 pass does not, which
is why the kernel never takes it.  ``tf32_round`` is held against an
independent rounding written with numpy, and ``b_operands_plain`` (the
kernel's B operands) against the weight it is made from.
"""

import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import so2conv as k3

LMAX, MMAX, CIN, COUT, EXTRA, E = 4, 2, 256, 128, 384, 48
LIMIT = 1e-5  # csrc/so2conv.cu's float32 limit, of max|plain|


def _tf32_reference(x: np.ndarray) -> np.ndarray:
    """Round float32 to the nearer of the two TF32 values around it (10
    explicit mantissa bits); ties go away from zero."""
    bits = x.astype(np.float32).view(np.uint32)
    down = (bits & np.uint32(0xFFFFE000)).view(np.float32)            # toward zero
    up = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32)
    d_down = np.abs(x.astype(np.float64) - down.astype(np.float64))
    d_up = np.abs(up.astype(np.float64) - x.astype(np.float64))
    return np.where(d_up <= d_down, up, down)


def _split(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    big = k3.tf32_round(t)
    return big, k3.tf32_round(t - big)


def _operands(seed: int = 0):
    rng = np.random.default_rng(seed)
    groups = k3._row_maps(LMAX, MMAX)
    K = sum(map(len, groups))
    ws = [torch.as_tensor((rng.standard_normal((len(r) * CIN, (EXTRA if g == 0 else 0)
                                                + len(r) * COUT))
                           / np.sqrt(len(r) * CIN)).astype(np.float32))
          for g, r in enumerate(groups)]
    x = torch.as_tensor(rng.standard_normal((E, K, CIN)).astype(np.float32))
    dy = torch.as_tensor(rng.standard_normal((E, K, COUT)).astype(np.float32))
    dex = torch.as_tensor(rng.standard_normal((E, EXTRA)).astype(np.float32))
    return ws, x, dy, dex


def _direction(kind: str, passes: int):
    """(emulated float32 result, float64 reference) of K3-fwd or K3-adj."""
    ws, x, dy, dex = _operands()

    def apply(a, a_extra, w):   # one bilinear product in float64
        w = [t.double() for t in w]
        if kind == "fwd":
            y, ex = k3.fwd_plain(a.double(), w, LMAX, MMAX, COUT, EXTRA)
            return torch.cat([y.reshape(E, -1), ex], dim=1)
        return k3.adj_plain(a.double(), a_extra.double(), w, LMAX, MMAX, CIN).reshape(E, -1)

    a, a_extra = (x, None) if kind == "fwd" else (dy, dex)
    (a_hi, a_lo) = _split(a)
    (e_hi, e_lo) = _split(a_extra) if a_extra is not None else (None, None)
    w_hi, w_lo = zip(*map(_split, ws))
    out = apply(a_hi, e_hi, w_hi)
    if passes == 3:
        out = out + apply(a_hi, e_hi, w_lo) + apply(a_lo, e_lo, w_hi)
    return out.float(), apply(a, a_extra, ws)


def test_tf32_round_matches_an_independent_rounding():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * np.float32(10.0) ** rng.integers(
            -30, 30, 20000).astype(np.float32),
        # exact ties: the 13 low bits are 0x1000
        ((rng.integers(0x00800000, 0x7F000000, 2000, dtype=np.uint32) & ~np.uint32(0x1FFF))
         | np.uint32(0x1000)).view(np.float32),
    ]).astype(np.float32)
    x = np.concatenate([x, -x])
    got = k3.tf32_round(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _tf32_reference(x).view(np.uint32))
    assert not np.any(got.view(np.uint32) & np.uint32(0x1FFF))


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),        # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),        # just below the tie rounds down
    (float("inf"), float("inf")),
])
def test_tf32_round_ties_away_and_passes_inf(value, want):
    assert k3.tf32_round(torch.tensor([value], dtype=torch.float32)).item() == want


@pytest.mark.parametrize("kind", ["fwd", "adj"])
def test_three_tf32_passes_stay_within_the_f32_limit(kind):
    got, want = _direction(kind, passes=3)
    err = (got.double() - want).abs().max().item()
    assert err <= LIMIT * want.abs().max().item(), err / want.abs().max().item()


@pytest.mark.parametrize("kind", ["fwd", "adj"])
def test_one_tf32_pass_misses_the_f32_limit(kind):
    got, want = _direction(kind, passes=1)
    err = (got.double() - want).abs().max().item()
    assert err > LIMIT * want.abs().max().item()


@pytest.mark.parametrize("adjoint", [False, True], ids=["fwd", "adj"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b_operands_rebuild_the_weight_in_the_kernel_layout(dtype, adjoint):
    ws, *_ = _operands(2)
    ws = [w.to(dtype) for w in ws]
    hi, lo = k3.b_operands_plain(ws, adjoint)
    for w, h, l_ in zip(ws, hi, lo if lo is not None else [None] * len(ws)):
        want = w if adjoint else w.t()          # [ndim, kdim], the depth contiguous
        assert h.is_contiguous() and h.shape == want.shape and h.dtype == dtype
        if dtype == torch.bfloat16:
            assert l_ is None
            assert torch.equal(h, want)
            continue
        assert torch.equal(h, k3.tf32_round(want.contiguous()))
        assert not torch.any(l_.view(torch.int32) & 0x1FFF)
        assert torch.all((h + l_ - want).abs() <= 2.0 ** -22 * want.abs())
