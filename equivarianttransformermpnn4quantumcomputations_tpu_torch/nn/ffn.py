"""Equivariant feed-forward network (port of the JAX package's nn/ffn.py).

SO3 linear -> separable-S2 activation -> SO3 linear, on full (mmax = lmax)
features (reference transformer_block.py:339-453).  The S2 activation here
is kernel K2's site on the GPU.

``StackedFeedForward`` is T such networks with weights stacked on a leading
target axis: the JAX package's ``nn.vmap`` of ``FeedForward`` over the QM9
heads (models/qm9.py:122-133).  Its T S2 activations run as one call over
[T N, K, hidden] (one K2a launch on the card).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.s2grid import S2Grid
from .activations import separable_s2_activation
from .layers import Linear
from .so3_layers import SO3Linear

__all__ = ["FeedForward", "StackedFeedForward"]


class FeedForward(nn.Module):
    def __init__(self, sphere_channels: int, hidden_channels: int,
                 output_channels: int, lmax: int, grid_full: S2Grid):
        super().__init__()
        self.grid = grid_full
        self.gating_linear = Linear(sphere_channels, hidden_channels)
        self.so3_linear_1 = SO3Linear(sphere_channels, hidden_channels, lmax)
        self.so3_linear_2 = SO3Linear(hidden_channels, output_channels, lmax)

    def forward(self, x):
        """x: [N, K_full, C] -> [N, K_full, output_channels]."""
        gating = self.gating_linear(x[:, 0, :])
        h = separable_s2_activation(gating, self.so3_linear_1(x), self.grid)
        return self.so3_linear_2(h)


class _StackedLinear(nn.Module):
    """T dense maps: weight [T, out, in], bias [T, out]; computes in the
    promoted type of input and weight, as ``Linear`` does."""

    def __init__(self, num: int, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(num, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, in] (shared by the T maps) -> [T, N, out]."""
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return (torch.einsum("ni,toi->tno", x.to(dt), self.weight.to(dt))
                + self.bias.to(dt)[:, None, :])


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


class StackedFeedForward(nn.Module):
    """``num`` FeedForwards over one input, weights on a leading axis."""

    def __init__(self, num: int, sphere_channels: int, hidden_channels: int,
                 output_channels: int, lmax: int, grid_full: S2Grid):
        super().__init__()
        self.grid = grid_full
        self.gating_linear = _StackedLinear(num, sphere_channels, hidden_channels)
        self.so3_linear_1 = _StackedSO3Linear(num, sphere_channels, hidden_channels, lmax)
        self.so3_linear_2 = _StackedSO3Linear(num, hidden_channels, output_channels, lmax)

    def forward(self, x):
        """x: [N, K_full, C] -> [T, N, K_full, output_channels]."""
        gating = self.gating_linear(x[:, 0, :])          # [T, N, H]
        h = self.so3_linear_1(x)                         # [T, N, K, H]
        T, N, K, H = h.shape
        h = separable_s2_activation(gating.reshape(T * N, H), h.reshape(T * N, K, H),
                                    self.grid)
        return self.so3_linear_2(h.reshape(T, N, K, H))
