"""Degree-wise SO(3) linear layer and the eSCN SO(2) convolution.

Port of the JAX package's nn/so3_layers.py (``SO3Linear``, ``SO2Conv``).
Parameters keep the JAX package's layouts ([in, out] matrices), so
utils/convert.py copies them unchanged.

In the edge-aligned frame a rotation by theta about the edge acts on the
pair (c_{+m}, c_{-m}) as multiplication of c_{+m} + i c_{-m} by e^{i m theta};
a complex-linear map in that pair commutes with it, which is what SO2Conv
applies, as one packed real product per order m:
``[yr yi] = [xr xi] @ [[wr, wi], [-wi, wr]]``.

``SO2Conv(conv_fused=True)`` runs every order of a site through kernel K3
(ops/cuda/so2conv.py), which reads and writes the l-primary rows directly;
the JAX package's ``KernelFlags.conv_fused`` is its counterpart and, as
there, it is off by default.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.cuda.so2conv import so2conv_fused, so2conv_supported
from ..ops.irreps import IrrepsLayout
from .layers import RadialMLP
from .partition import declare, declare_tp

__all__ = ["SO3Linear", "SO2Conv"]


@functools.lru_cache(maxsize=None)
def _rad_chunk_map(lay: IrrepsLayout) -> np.ndarray:
    """l-primary row -> radial chunk index (the radial MLP emits one
    Cin-wide chunk per (l, m >= 0) pair, m-primary order; the +m and -m
    rows share their pair's chunk)."""
    m_abs = np.abs(np.asarray(lay.m_complex))
    ls = np.asarray(lay.l_harmonic)
    base = np.cumsum([0] + [int(lay.m_size[m]) for m in range(lay.mmax)])
    return np.asarray([base[m_abs[k]] + ls[k] - m_abs[k] for k in range(len(ls))],
                      dtype=np.int64)


class SO3Linear(nn.Module):
    """Per-degree linear map over [N, K, C]; bias only on l = 0.

    weight: [lmax+1, in, out] (degree l's block maps its 2l+1 rows).
    ``tp``: ``"col"`` splits ``out`` (and the bias), ``"row"`` splits ``in``
    (nn/partition.py).  With a ``ModelGroup`` (``mp``) a column layer takes
    its replicated input through ``copy_to``; a row layer sums its partial
    products with ``reduce_from`` and then adds the bias once.
    """

    def __init__(self, in_features: int, out_features: int, lmax: int,
                 tp: str | None = None):
        super().__init__()
        self.lmax = lmax
        self.weight = nn.Parameter(torch.empty(lmax + 1, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        declare_tp(self, tp, {"weight": (1, 2)}, "bias")
        self.mp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        tp = self.tp if self.mp is not None else None
        if tp == "col":
            x = self.mp.copy_to(x)
        out = [x[:, l * l : (l + 1) ** 2, :] @ w[l] for l in range(self.lmax + 1)]
        if tp == "row":
            out = self.mp.reduce_from(torch.cat(out, dim=1))
            return torch.cat([out[:, :1] + self.bias.to(x.dtype), out[:, 1:]], dim=1)
        out[0] = out[0] + self.bias.to(x.dtype)
        return torch.cat(out, dim=1)


class SO2Conv(nn.Module):
    """SO(2) convolution over all orders m in the edge-aligned frame.

    Call: (x [E, K_red, C_in], edge_scalars [E, D] | None)
        -> (out [E, K_red, C_out] | None, extra [E, extra_m0] | None)

    ``extra_m0``: extra invariant outputs carved out of the m = 0 block.
    ``rad_channels``: an edge MLP giving per-edge, per-(l, m>=0) input
    weights.  ``m0_only``: x is the m = 0 block [E, lmax+1, C_in] and only
    the m = 0 outputs are wanted (the GATA value path); the m > 0 weights
    still exist (the same parameters as the full conv) but are not used, and
    the message output is None.  ``conv_fused``: a full site whose widths
    the kernel takes (``so2conv_supported``) runs through K3; ``m0_only``
    sites never do.

    ``tp`` (nn/partition.py): ``"col"`` splits every weight's output
    columns and ``b_m0``: a rank holds its 1/M of each chunk of
    ``extra_chunks`` (the extra outputs' parts: alpha, gates) and of each
    degree's C_out channels, so its outputs are the extra parts' shares and
    C_out / M channels of every row.  ``"row"`` splits the input rows (each
    degree's C_in channels); ``b_m0`` stays whole.  With a ``ModelGroup``
    (``mp``) a column conv takes its replicated inputs (after the radial
    scale) through ``copy_to``; a row conv sums its partial outputs with
    ``reduce_from`` (or, ``scatter=True``, keeps its contiguous 1/M of the
    output channels with ``reduce_scatter``) and adds the bias after.  The
    radial MLP stays replicated.
    """

    def __init__(self, layout: IrrepsLayout, in_channels: int, out_channels: int,
                 extra_m0: int = 0, rad_channels: Optional[Sequence[int]] = None,
                 m0_only: bool = False, conv_fused: bool = False, tp: str | None = None,
                 extra_chunks: Optional[Sequence[int]] = None):
        super().__init__()
        self.layout = layout
        self.cin, self.cout = in_channels, out_channels
        self.extra_m0, self.m0_only = extra_m0, m0_only
        self.conv_fused = conv_fused and not m0_only
        self.fused = (self.conv_fused
                      and so2conv_supported(layout, in_channels, out_channels, extra_m0))
        L0 = int(layout.m_size[0])
        self.rad = None
        if rad_channels is not None:
            n_rad = int(layout.m_size.sum()) * in_channels
            self.rad = RadialMLP(tuple(rad_channels) + (n_rad,))
        self.w_m0 = nn.Parameter(torch.empty(L0 * in_channels, extra_m0 + L0 * out_channels))
        self.b_m0 = nn.Parameter(torch.zeros(extra_m0 + L0 * out_channels))
        for m in range(1, layout.mmax + 1):
            Lm = int(layout.m_size[m])
            setattr(self, f"w_m{m}_r", nn.Parameter(torch.empty(Lm * in_channels, Lm * out_channels)))
            setattr(self, f"w_m{m}_i", nn.Parameter(torch.empty(Lm * in_channels, Lm * out_channels)))
        self.register_buffer("to_m", torch.as_tensor(layout.to_m_perm, dtype=torch.long),
                             persistent=False)
        self.register_buffer("from_m", torch.as_tensor(layout.from_m_perm, dtype=torch.long),
                             persistent=False)
        self.register_buffer("rad_chunk", torch.as_tensor(_rad_chunk_map(layout)),
                             persistent=False)
        self.register_buffer("m0_rows", torch.as_tensor(
            np.flatnonzero(np.asarray(layout.m_complex) == 0), dtype=torch.long),
            persistent=False)
        self._declare(tp, extra_chunks)
        self.mp = None

    def _declare(self, tp, extra_chunks) -> None:
        if tp not in (None, "col", "row"):
            raise ValueError(f"unknown tp role: {tp!r}")
        if tp == "row" and (self.extra_m0 or self.rad is not None):
            raise ValueError("a row-split SO2Conv has no extra outputs and no radial MLP")
        self.tp = tp
        if tp is None:
            return
        extra = list(extra_chunks or ([self.extra_m0] if self.extra_m0 else []))
        if sum(extra) != self.extra_m0:
            raise ValueError(f"extra_chunks {extra} do not add up to {self.extra_m0}")
        width = self.cout if tp == "col" else self.cin
        dim = 1 if tp == "col" else 0
        L0 = int(self.layout.m_size[0])
        declare(self, "w_m0", dim, (extra if tp == "col" else []) + [width] * L0)
        if tp == "col":
            declare(self, "b_m0", 0, extra + [width] * L0)
        for m in range(1, self.layout.mmax + 1):
            Lm = int(self.layout.m_size[m])
            for part in ("r", "i"):
                declare(self, f"w_m{m}_{part}", dim, [width] * Lm)

    def _packed_weights(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """[w_m0] and the butterfly [[wr, wi], [-wi, wr]] of each m > 0, built
        per call so that autograd carries dW back to w_m{m}_r / _i."""
        ws = [self.w_m0.to(dtype)]
        for m in range(1, self.layout.mmax + 1):
            wr = getattr(self, f"w_m{m}_r").to(dtype)
            wi = getattr(self, f"w_m{m}_i").to(dtype)
            ws.append(torch.cat([torch.cat([wr, wi], 1), torch.cat([-wi, wr], 1)], 0))
        return ws

    def _forward_fused(self, x: torch.Tensor, rad: torch.Tensor | None, cout: int,
                       extra_m0: int, bias: bool = True, live: torch.Tensor | None = None):
        """All orders in one K3 launch; biases added after the kernel;
        ``live``: K3's weight gradient reduces rows ``[0, live)`` only."""
        lay, E = self.layout, x.shape[0]
        if rad is not None:
            rr = rad.reshape(E, int(lay.m_size.sum()), self.cin)
            x = x * rr[:, self.rad_chunk, :].to(x.dtype)
        if self.tp == "col" and self.mp is not None:
            x = self.mp.copy_to(x)
        y, extra = so2conv_fused(x, self._packed_weights(x.dtype), lay.lmax, lay.mmax,
                                 cout, extra_m0, live)
        if not bias:
            return y, extra
        b = self.b_m0.to(y.dtype)
        if extra_m0:
            extra = extra + b[: extra_m0]
        bias_rows = y.new_zeros(y.shape[1], cout).index_copy(
            0, self.m0_rows, b[extra_m0 :].reshape(-1, cout))
        return y + bias_rows, extra

    def forward(self, x: torch.Tensor, edge_scalars: torch.Tensor | None = None,
                scatter: bool = False, live: torch.Tensor | None = None):
        """``live``: a device int32 scalar when the outputs' gradients are
        zero in rows ``[live, E)`` (the ragged layout's padding edges), read
        by K3's weight gradient only (ops/cuda/so2conv.py)."""
        mp, lay, E = self.mp, self.layout, x.shape[0]
        col, row = mp is not None and self.tp == "col", mp is not None and self.tp == "row"
        M = mp.size if mp is not None else 1
        # the rank's widths: a column conv's outputs, a row conv's inputs
        Cin = self.cin // M if row else self.cin
        Cout = self.cout // M if col else self.cout
        extra_m0 = self.extra_m0 // M if col else self.extra_m0
        into = mp.copy_to if col else (lambda t: t)
        L0 = int(lay.m_size[0])
        rad = self.rad(edge_scalars) if self.rad is not None else None
        fused = (self.fused if mp is None
                 else self.conv_fused and so2conv_supported(lay, Cin, Cout, extra_m0))
        if fused:
            y, extra = self._forward_fused(x, rad, Cout, extra_m0, bias=not row, live=live)
        else:
            xm = x if self.m0_only else x[:, self.to_m, :]  # m-primary
            x0 = xm[:, :L0, :].reshape(E, L0 * Cin)
            if rad is not None:
                x0 = x0 * rad[:, : L0 * Cin]
            x0 = into(x0)
            if self.m0_only:
                # only the extra columns are read downstream (or all of y0)
                n = extra_m0 or self.w_m0.shape[1]
                y0 = x0 @ self.w_m0[:, :n].to(x0.dtype) + self.b_m0[:n].to(x0.dtype)
                return None, y0
            y0 = x0 @ self.w_m0.to(x0.dtype)
            if not row:   # a row conv adds its bias once, after the reduction
                y0 = y0 + self.b_m0.to(x0.dtype)
            extra = None
            if extra_m0:
                extra, y0 = y0[:, :extra_m0], y0[:, extra_m0:]
            blocks = [y0.reshape(E, L0, Cout)]
            offset, offset_rad = L0, L0 * Cin
            wbigs = self._packed_weights(x.dtype)
            for m in range(1, lay.mmax + 1):
                Lm = int(lay.m_size[m])
                xr = xm[:, offset : offset + Lm, :].reshape(E, Lm * Cin)
                xi = xm[:, offset + Lm : offset + 2 * Lm, :].reshape(E, Lm * Cin)
                if rad is not None:
                    rm = rad[:, offset_rad : offset_rad + Lm * Cin]
                    xr, xi = xr * rm, xi * rm
                    offset_rad += Lm * Cin
                y = into(torch.cat([xr, xi], dim=1)) @ wbigs[m]
                blocks.append(y.reshape(E, 2 * Lm, Cout))
                offset += 2 * Lm
            y = torch.cat(blocks, dim=1)[:, self.from_m, :]
        if not row:
            return y, extra
        # the rank's partial sums: whole (reduce_from) or its output channels
        b = self.b_m0.to(y.dtype).reshape(L0, Cout)
        if scatter:
            y = mp.reduce_scatter(y, dim=-1)
            b = mp.copy_to(b)[:, mp.part(Cout)]
        else:
            y = mp.reduce_from(y)
        bias_rows = y.new_zeros(y.shape[1], b.shape[1]).index_copy(0, self.m0_rows, b)
        return y + bias_rows, None
