"""Equivariant feed-forward networks (port of the JAX package's nn/ffn.py).

``FeedForward``: SO3 linear -> activation -> SO3 linear on full
(mmax = lmax) features (reference transformer_block.py:339-453), with the
JAX package's activation options: the separable S2 activation (the
default; kernel K2's site on the GPU), the gate activation
(``use_gate_act``), the plain S2 activation (``use_sep_s2_act=False``, also
K2), or the grid MLP (``use_grid_mlp``: three dense maps on the grid
points, with or without separate l = 0 scalars).

``FeedForward(num=T)`` is T such networks with weights stacked on a leading
target axis: the JAX package's ``nn.vmap`` of ``FeedForward`` over the QM9
heads (models/qm9.py:122-133).  Its T activations run as one call over
[T N, K, hidden] (one K2a launch on the card).

``ESENFeedForward``: the eSEN-style FFN, gated directly in SH space with no
grid (reference GATA_and_all2all_escninsipred_envelope_and_simple_gating
fork, transformer_block.py:369-475).

Tensor-parallel roles (nn/partition.py, the JAX package's): ``so3_linear_1``,
the gating scalars (``gating_linear`` / ``scalar_mlp``, the eSEN
``gate_proj_l``) and the grid MLP's first and last maps split the hidden
channels (column), ``so3_linear_2`` and the grid MLP's middle map contract
them (row).  With a ``ModelGroup`` every activation runs on the rank's H/M
hidden channels (kernel K2 at [N, K, H/M]); the grid MLP gathers the grid
values before its first map, and the eSEN gates gather the l = 0 scalars.
The stacked form (``num``) declares no roles.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.s2grid import S2Grid
from .activations import gate_activation, s2_activation, separable_s2_activation
from .layers import Linear, StackedLinear, scaled_silu
from .so3_layers import SO3Linear

__all__ = ["FeedForward", "ESENFeedForward"]


class _StackedSO3Linear(nn.Module):
    """T ``SO3Linear`` maps: weight [T, lmax+1, in, out], bias [T, out]."""

    def __init__(self, num: int, in_features: int, out_features: int, lmax: int):
        super().__init__()
        self.lmax = lmax
        self.weight = nn.Parameter(torch.empty(num, lmax + 1, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(num, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, K, in] (shared) or [T, N, K, in] -> [T, N, K, out]."""
        w = self.weight.to(x.dtype)
        eq = "nki,tio->tnko" if x.dim() == 3 else "tnki,tio->tnko"
        out = [torch.einsum(eq, x[..., l * l : (l + 1) ** 2, :], w[:, l])
               for l in range(self.lmax + 1)]
        out[0] = out[0] + self.bias.to(x.dtype)[:, None, None, :]
        return torch.cat(out, dim=2)


class FeedForward(nn.Module):
    """x [N, K_full, C] -> [N, K_full, output_channels]; with ``num`` (the
    stacked form) -> [num, N, K_full, output_channels]."""

    def __init__(self, sphere_channels: int, hidden_channels: int,
                 output_channels: int, lmax: int, grid_full: S2Grid,
                 use_gate_act: bool = False, use_grid_mlp: bool = False,
                 use_sep_s2_act: bool = True, num: int | None = None):
        super().__init__()
        self.grid, self.lmax, self.num = grid_full, lmax, num
        self.use_gate_act, self.use_grid_mlp = use_gate_act, use_grid_mlp
        self.use_sep_s2_act = use_sep_s2_act
        C, H = sphere_channels, hidden_channels

        def dense(i, o, bias=True, tp="col", chunks=None):
            if num is None:
                return Linear(i, o, bias=bias, tp=tp, out_chunks=chunks)
            return StackedLinear(num, i, o, bias)

        if use_grid_mlp:
            if use_sep_s2_act:
                self.scalar_mlp = dense(C, H)
        elif use_gate_act:
            self.gating_linear = dense(C, lmax * H, chunks=[H] * lmax)
        elif use_sep_s2_act:
            self.gating_linear = dense(C, H)
        so3 = (SO3Linear if num is None
               else (lambda *a, tp=None: _StackedSO3Linear(num, *a)))
        self.so3_linear_1 = so3(C, H, lmax, tp="col")
        if use_grid_mlp:
            for i in range(3):
                setattr(self, f"grid_mlp_{i}", dense(H, H, bias=False,
                                                     tp="row" if i == 1 else "col"))
        self.so3_linear_2 = so3(H, output_channels, lmax, tp="row")
        self.mp = None

    def _dense(self, mod: nn.Module, x: torch.Tensor, shared: bool = False) -> torch.Tensor:
        return mod(x) if self.num is None else mod(x, shared=shared)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x[:, 0, :]
        gating = None
        if self.use_grid_mlp:
            if self.use_sep_s2_act:
                gating = F.silu(self._dense(self.scalar_mlp, x0, shared=True))
        elif self.use_gate_act or self.use_sep_s2_act:
            gating = self._dense(self.gating_linear, x0, shared=True)
        h = self.so3_linear_1(x)
        lead, (K, H) = h.shape[:-3], h.shape[-2:]
        h = h.reshape(-1, K, H)                  # the T heads side by side
        if gating is not None:
            gating = gating.reshape(-1, gating.shape[-1])

        if self.use_grid_mlp:
            g = self.grid.to_grid(h)
            if self.mp is not None:   # the column map reads every channel
                g = self.mp.gather(g, dim=-1)
            for i in range(3):
                g = self._dense(getattr(self, f"grid_mlp_{i}"),
                                g.reshape(lead + (-1,) + tuple(g.shape[1:])))
                g = g.reshape((-1,) + tuple(g.shape[len(lead) + 1:]))
                if i < 2:
                    g = F.silu(g)
            h = self.grid.from_grid(g)
            if self.use_sep_s2_act:
                h = torch.cat([gating[:, None, :], h[:, 1:, :]], dim=1)
        elif self.use_gate_act:
            h = gate_activation(gating, h, self.lmax, self.lmax, H)
        elif self.use_sep_s2_act:
            h = separable_s2_activation(gating, h, self.grid)
        else:
            h = s2_activation(h, self.grid)
        return self.so3_linear_2(h.reshape(lead + (-1, K, H)))


class ESENFeedForward(nn.Module):
    """SO3Linear (expand) -> l=0: ScaledSiLU; l>0: x^(l) *
    sigmoid(gate_proj_l(ScaledSiLU(x^(0)))) -> SO3Linear (contract).

    The gate projections start at weight 0 / bias 2.0, so the gates start
    nearly open (reference :436-439); the gates are invariant scalars
    shared across m within each l, so the FFN is exactly equivariant.
    """

    def __init__(self, sphere_channels: int, hidden_channels: int,
                 output_channels: int, lmax: int):
        super().__init__()
        self.lmax = lmax
        self.so3_linear_1 = SO3Linear(sphere_channels, hidden_channels, lmax, tp="col")
        for l in range(1, lmax + 1):
            setattr(self, f"gate_proj_{l}", Linear(hidden_channels, hidden_channels, tp="col"))
        self.so3_linear_2 = SO3Linear(hidden_channels, output_channels, lmax, tp="row")
        self.mp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.so3_linear_1(x)
        out_scalar = scaled_silu(h[:, :1, :])
        out = [out_scalar]
        summary = out_scalar[:, 0, :]
        if self.mp is not None:   # the column gates read every channel
            summary = self.mp.gather(summary, dim=-1)
        for l in range(1, self.lmax + 1):
            gate = torch.sigmoid(getattr(self, f"gate_proj_{l}")(summary))
            out.append(h[:, l * l : (l + 1) ** 2, :] * gate[:, None, :])
        return self.so3_linear_2(torch.cat(out, dim=1))
