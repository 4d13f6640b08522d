"""K2: fused S2 point-sample activation and its two adjoints, for Hopper.

Port of the JAX package's ops/pallas/s2act.py (kernels ``_k1``, ``_k2`` and
``_k3``).  The S2 activation ``out = F^T silu(A x)`` (to-grid, SiLU,
from-grid; tables of ops/s2grid.py) is the largest op of the network: its
grid tensor is ~P/K = 13x the coefficient tensor.  The kernels in
``csrc/s2act.cu`` keep it out of device memory:

* K2a: ``out = F^T silu(A x)``;
* K2b: ``dx = A^T (silu'(A x) * (F dout))``, the backward of K2a;
* K2c: ``ddout = F^T (silu'(A x) * (A ddx))`` and
  ``dx2 = A^T (silu''(A x) * (F dout) * (A ddx))``, the backward of K2b
  (the JAX package's ``_k3``), which force training runs in the loss
  backward.

All three run on the tensor cores (``mma.sync``; 3xTF32 in float32, bf16
products in bfloat16); their tables are prepared here, once per grid,
device, dtype and kernel, in the shared-memory layout the kernel reads
(``tc_layout``, ``tc_tables``).  In float32 the three kernels read one
table set.

``s2act_fused`` sits in ``_S2Act`` (backward = ``_S2ActBackward``, i.e.
K2b), whose backward is ``_S2ActGradOfGrad`` (K2c).  K2c's own backward
raises: third order is not supported, as in the JAX package, whose chain
ends at ``_k3``.
CPU tensors run the plain PyTorch versions (``k1_plain``, ``k2_plain``,
``k3_plain``); CUDA tensors launch the kernels; nothing falls back.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from ..s2grid import S2Grid
from .edge_rotate import SMEM_LIMIT
from .so2conv import tf32_round

__all__ = ["s2act_fused", "s2act_reference", "k1_plain", "k2_plain", "k3_plain",
           "TC_KERNELS", "tc_layout", "tc_tables", "tc_tables_plain", "launches",
           "launches_by_k"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the kernels on the tensor cores, by their number in ``tc_layout`` and in
# csrc/s2act.cu (KIND): K2a, K2b, K2c
TC_KERNELS = ("k1", "k2", "k3")
# kernel launches (the launch wrapper adds one per launch), in all and per
# (kernel, K) instance
launches = {"k1": 0, "k2": 0, "k3": 0}
launches_by_k: dict[tuple[str, int], int] = collections.defaultdict(int)


def k1_plain(x: torch.Tensor, A: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Plain version of K2a: x [N, K, C], A/F [P, K] -> F^T silu(A x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g = torch.matmul(A.to(acc), x.to(acc))
    return torch.matmul(F.t().to(acc), Fn.silu(g)).to(x.dtype)


def k2_plain(x: torch.Tensor, dout: torch.Tensor, A: torch.Tensor,
             F: torch.Tensor) -> torch.Tensor:
    """Plain version of K2b: dx = A^T (silu'(A x) * (F dout))."""
    acc = torch.promote_types(x.dtype, torch.float32)
    A, F = A.to(acc), F.to(acc)
    g = torch.matmul(A, x.to(acc))
    s = torch.sigmoid(g)
    h = torch.matmul(F, dout.to(acc))
    return torch.matmul(A.t(), s * (1.0 + g * (1.0 - s)) * h).to(x.dtype)


def k3_plain(x: torch.Tensor, dout: torch.Tensor, ddx: torch.Tensor,
             A: torch.Tensor, F: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2c: (ddout, dx2), the vjp of K2b at (x, dout) for ddx."""
    acc = torch.promote_types(x.dtype, torch.float32)
    A, F = A.to(acc), F.to(acc)
    g = torch.matmul(A, x.to(acc))
    u = torch.matmul(A, ddx.to(acc))
    h = torch.matmul(F, dout.to(acc))
    s = torch.sigmoid(g)
    d1 = s * (1.0 + g * (1.0 - s))
    d2 = s * (1.0 - s) * (2.0 + g * (1.0 - 2.0 * s))
    ddout = torch.matmul(F.t(), d1 * u)
    dx2 = torch.matmul(A.t(), d2 * h * u)
    return ddout.to(x.dtype), dx2.to(x.dtype)


class TcLayout(NamedTuple):
    """The tensor-core kernel's shapes (csrc/s2act.cu: ``Tc``): the first
    products' depth ``kp`` (K padded to 8 in f32, 16 in bf16), the second
    products' width ``kn`` (K padded to 8), the grid points ``pp`` (P padded
    to 16), the 32-bit words per row of a [pp, .] table (``spk``) and of a
    bf16 [kn, .] table (``skp``), both 4 mod 8, the 16-channel tiles per
    warp (``mt``), the warps per block, and the table words (the block's
    dynamic shared memory / 4)."""
    kp: int
    kn: int
    pp: int
    spk: int
    skp: int
    mt: int
    warps: int
    words: int


def tc_layout(K: int, P: int, dtype: torch.dtype, kernel: int) -> TcLayout:
    """The layout of K2a (``kernel`` 0 or False), K2b (1 or True) or K2c
    (2) on a [P, K] grid."""
    f32 = dtype == torch.float32
    kp = -(-K // (8 if f32 else 16)) * (8 if f32 else 16)
    kn = -(-K // 8) * 8
    pp = -(-P // 16) * 16
    spk = kp + 4 if f32 else kp // 2 + 4
    skp = pp // 2 + 4
    mt = 2 if not f32 and kp <= 32 else 1
    if kernel == 2:
        warps = 8 if f32 or mt == 2 else 12
    elif mt == 2:
        warps = 12
    elif not f32:
        warps = 16
    elif kernel:
        warps = 12 if kp <= 32 else 8
    else:
        warps = 16 if kp <= 32 else 12
    # bf16: [pp, spk] tables A (and F), then [kn, skp] tables F^T / A^T
    by_k, by_p = ((1, 1), (2, 1), (2, 2))[kernel]
    words = 4 * pp * spk if f32 else by_k * pp * spk + by_p * kn * skp
    return TcLayout(kp, kn, pp, spk, skp, mt, warps, words)


def _pad(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = t.new_zeros(rows, cols)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def tc_tables_plain(A: torch.Tensor, F: torch.Tensor, dtype: torch.dtype,
                    kernel: int) -> torch.Tensor:
    """The tables of K2a, K2b or K2c (``kernel`` as in ``tc_layout``) from
    float32 A, F [P, K], one flat tensor in the kernel's shared-memory
    layout:

    * float32 (every kernel): A big, A small, F big, F small, each
      [pp, spk] (TF32 parts, big + small = the table to ~2^-22 relative);
    * bfloat16, K2a: A [pp, 2 spk] (pairs along k), F^T [kn, 2 skp] (pairs
      along p); K2b: A, F [pp, 2 spk] and A^T [kn, 2 skp]; K2c: A, F
      [pp, 2 spk], F^T and A^T [kn, 2 skp].

    Zero-padded everywhere outside the [P, K] (or [K, P]) block."""
    P, K = A.shape
    L = tc_layout(K, P, dtype, kernel)
    if dtype == torch.float32:
        parts = []
        for t in (A, F):
            full = _pad(t, L.pp, L.spk)
            big = tf32_round(full)
            parts += [big, tf32_round(full - big)]
    else:
        by_k = ((A,), (A, F), (A, F))[kernel]
        by_p = ((F,), (A,), (F, A))[kernel]
        parts = ([_pad(t.to(dtype), L.pp, 2 * L.spk) for t in by_k]
                 + [_pad(t.t().to(dtype), L.kn, 2 * L.skp) for t in by_p])
    return torch.cat([p.reshape(-1) for p in parts])


def tc_tables(grid: S2Grid, device: str, dtype: torch.dtype, kernel: int) -> torch.Tensor:
    """``tc_tables_plain`` of ``grid``, cached per grid, device, dtype and
    kernel; in float32 the three kernels share one set."""
    return _tc_tables(grid, device, dtype, 1 if dtype == torch.float32 else int(kernel))


@functools.lru_cache(maxsize=None)
def _tc_tables(grid: S2Grid, device: str, dtype: torch.dtype, kernel: int) -> torch.Tensor:
    return tc_tables_plain(*grid.tables(device), dtype, kernel).contiguous()


def _check(x: torch.Tensor, *others: torch.Tensor, grid: S2Grid) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"s2act kernel takes float32 or bfloat16, not {x.dtype}")
    for t in (x, *others):
        if not t.is_contiguous():
            raise ValueError("s2act inputs must be contiguous")
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("s2act inputs must match x in shape, dtype and device")
    K = x.shape[1]
    if grid.to_grid_np.shape[1] != K:
        raise ValueError(f"x has {K} coefficients, the grid has {grid.to_grid_np.shape[1]}")


def _launch(kernel: int, grid: S2Grid, *ins: torch.Tensor) -> list[torch.Tensor]:
    """Launch K2a, K2b or K2c (``kernel`` 0, 1, 2) on ins = (x, dout, ddx)
    or its first one or two."""
    from . import build

    x = ins[0]
    N, K, C = x.shape
    _check(*ins, grid=grid)
    L = tc_layout(K, grid.to_grid_np.shape[0], x.dtype, kernel)
    if 4 * L.words > SMEM_LIMIT:
        raise ValueError(f"s2act: the tables of a {grid.to_grid_np.shape} grid take "
                         f"{4 * L.words} B of shared memory, more than a block's {SMEM_LIMIT}")
    tables = tc_tables(grid, str(x.device), x.dtype, kernel)
    outs = [torch.empty_like(x) for _ in range(2 if kernel == 2 else 1)]
    ptr = [t.data_ptr() for t in ins] + [0] * (3 - len(ins))
    lib = build.library("s2act")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.etq_s2act(_DTYPE_CODE[x.dtype], kernel, K, *ptr, tables.data_ptr(), L.words,
                       outs[0].data_ptr(), outs[-1].data_ptr() if kernel == 2 else 0,
                       N, C, L.pp, stream)
    name = TC_KERNELS[kernel]
    build.check("s2act", rc, f"s2act.{name}")
    launches[name] += 1
    launches_by_k[(name, K)] += 1
    return outs


def k1(x: torch.Tensor, grid: S2Grid) -> torch.Tensor:
    """K2a on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return _launch(0, grid, x)[0]
    A, F = grid.tables(str(x.device))
    return k1_plain(x, A, F)


def k2(x: torch.Tensor, dout: torch.Tensor, grid: S2Grid) -> torch.Tensor:
    """K2b on a CUDA tensor, its plain version on a CPU tensor."""
    if x.is_cuda:
        return _launch(1, grid, x, dout)[0]
    A, F = grid.tables(str(x.device))
    return k2_plain(x, dout, A, F)


def k3(x: torch.Tensor, dout: torch.Tensor, ddx: torch.Tensor,
       grid: S2Grid) -> tuple[torch.Tensor, torch.Tensor]:
    """K2c on CUDA tensors, its plain version on CPU tensors: (ddout, dx2)."""
    if x.is_cuda:
        return tuple(_launch(2, grid, x, dout, ddx))
    A, F = grid.tables(str(x.device))
    return k3_plain(x, dout, ddx, A, F)


class _S2ActGradOfGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dout, ddx, grid):
        return k3(x, dout, ddx, grid)

    @staticmethod
    def backward(ctx, g_ddout, g_dx2):
        raise NotImplementedError(
            "third-order derivatives of the fused S2 activation are not "
            "supported: the chain ends at K2c (the JAX package's _k3 has no "
            "custom_vjp either)"
        )


class _S2ActBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dout, grid):
        ctx.save_for_backward(x, dout)
        ctx.grid = grid
        return k2(x, dout, grid)

    @staticmethod
    def backward(ctx, ddx):
        x, dout = ctx.saved_tensors
        ddout, dx2 = _S2ActGradOfGrad.apply(x, dout, ddx.contiguous(), ctx.grid)
        return dx2, ddout, None


class _S2Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x)
        ctx.grid = grid
        return k1(x, grid)

    @staticmethod
    def backward(ctx, dout):
        (x,) = ctx.saved_tensors
        return _S2ActBackward.apply(x, dout.contiguous(), ctx.grid), None


def s2act_fused(x: torch.Tensor, grid: S2Grid) -> torch.Tensor:
    """Fused S2 activation ``F^T silu(A x)`` for x [N, K, C]."""
    return _S2Act.apply(x.contiguous(), grid)


def s2act_reference(x: torch.Tensor, grid: S2Grid) -> torch.Tensor:
    """Unfused reference: from_grid(silu(to_grid(x)))."""
    return grid.from_grid(Fn.silu(grid.to_grid(x)))
