"""Transformer block (port of the JAX package's nn/block.py ``TransBlock``,
``GraphDropPath`` and ``EquivariantDropout``).

With ``gata=True`` (GATA-V2) HTR first refines the edge stream ``t_ij``;
then, in both variants, pre-norm attention and pre-norm FFN, each with a
residual.  Both residual branches pass drop-path (whole graphs) and
equivariant dropout (whole channels); both are active only in
``train()`` mode, with masks drawn from the caller's ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.irreps import IrrepsLayout
from ..ops.s2grid import S2Grid
from ..ops.segment import gather_dst, gather_nodes
from .attention import GraphAttention
from .ffn import FeedForward
from .gata import HTR
from .layers import keep_mask
from .norms import EquivariantRMSNormSH

__all__ = ["TransBlock", "GraphDropPath", "EquivariantDropout"]


class GraphDropPath(nn.Module):
    """Drop whole graphs from the residual branch (reference drop.py:49-68)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, graph_idx, num_graphs: int,
                generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        m = keep_mask((num_graphs,), keep, generator, x.device)[graph_idx].to(x.dtype)
        return x * m.reshape((-1,) + (1,) * (x.dim() - 1)) / keep


class EquivariantDropout(nn.Module):
    """Channel dropout with one mask shared across the coefficient axis
    (reference drop.py:119-149): masking whole channels preserves
    equivariance."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        m = keep_mask((x.shape[0], 1, x.shape[2]), keep, generator, x.device)
        return x * m.to(x.dtype) / keep


class TransBlock(nn.Module):
    def __init__(self, layout_full: IrrepsLayout, layout_red: IrrepsLayout,
                 grid_red: S2Grid, grid_full: S2Grid, sphere_channels: int,
                 attn_hidden_channels: int, num_heads: int,
                 attn_alpha_channels: int, attn_value_channels: int,
                 ffn_hidden_channels: int, max_num_elements: int,
                 edge_channels_list: Sequence[int], edge_channels: int,
                 alpha_drop: float = 0.0, drop_path_rate: float = 0.0,
                 proj_drop: float = 0.0, gata: bool = True, conv_fused: bool = False,
                 normalize_attn_output: bool = True, use_phi_every_layer: bool = False):
        super().__init__()
        lmax = layout_full.lmax
        self.gata = gata
        if gata:
            self.htr = HTR(sphere_channels, edge_channels, lmax)
        self.attn_norm = EquivariantRMSNormSH(lmax, sphere_channels)
        self.ga = GraphAttention(
            layout_full, layout_red, grid_red, sphere_channels, attn_hidden_channels,
            num_heads, attn_alpha_channels, attn_value_channels,
            sphere_channels, max_num_elements, edge_channels_list,
            edge_channels, alpha_drop, gata, conv_fused, normalize_attn_output,
            use_phi_every_layer,
        )
        self.drop_path = GraphDropPath(drop_path_rate)
        self.proj_drop = EquivariantDropout(proj_drop)
        self.ffn_norm = EquivariantRMSNormSH(lmax, sphere_channels)
        self.ffn = FeedForward(sphere_channels, ffn_hidden_channels,
                               sphere_channels, lmax, grid_full)

    def forward(self, x, atomic_numbers, edge_scalars, edge_src, edge_dst,
                edge_mask, wigner, t_ij, rl_ij, k: int, graph_idx,
                num_graphs: int, generator: Optional[torch.Generator] = None, phi_r=None):
        """Returns (x, t_ij); ``t_ij`` and ``rl_ij`` are None without GATA,
        ``phi_r`` (the distance RBF) without ``use_phi_every_layer``."""
        if self.gata:
            X_i = gather_nodes(x, edge_src)[:, 1:, :]
            X_j = gather_dst(x, k)[:, 1:, :]
            t_ij = self.htr(t_ij, X_i, X_j, rl_ij)
        h = self.ga(self.attn_norm(x), atomic_numbers, edge_scalars, edge_src,
                    edge_dst, edge_mask, wigner, t_ij, rl_ij, k, generator, phi_r)
        h = self.drop_path(h, graph_idx, num_graphs, generator)
        x = x + self.proj_drop(h, generator)
        h = self.drop_path(self.ffn(self.ffn_norm(x)), graph_idx, num_graphs, generator)
        x = x + self.proj_drop(h, generator)
        return x, t_ij
