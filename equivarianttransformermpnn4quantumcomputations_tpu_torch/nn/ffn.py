"""Equivariant feed-forward network (port of the JAX package's nn/ffn.py).

SO3 linear -> separable-S2 activation -> SO3 linear, on full (mmax = lmax)
features (reference transformer_block.py:339-453).  The S2 activation here
is kernel K2's site on the GPU.
"""

from __future__ import annotations

import torch.nn as nn

from ..ops.s2grid import S2Grid
from .activations import separable_s2_activation
from .layers import Linear
from .so3_layers import SO3Linear

__all__ = ["FeedForward"]


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
