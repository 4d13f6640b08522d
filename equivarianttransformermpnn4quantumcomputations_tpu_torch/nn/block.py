"""Transformer block (port of the JAX package's nn/block.py ``TransBlock``,
``GraphDropPath`` and ``EquivariantDropout``).

With ``gata=True`` (GATA-V2) HTR first refines the edge stream ``t_ij``
(and with ``dual_stream`` AngularHTR then refines the angular stream
``a_ij``); then pre-norm attention and pre-norm FFN, each with a residual.
``norm_type`` picks the norm (nn/norms.py); ``ffn_variant`` the FFN:
'standard' (nn/ffn.py:FeedForward with the activation options), 'moe' /
'moe_breaking' (nn/moe.py), 'esen' (nn/ffn.py:ESENFeedForward) or
'tensor_product' (nn/dual_stream.py).  Both residual branches pass drop-path (whole graphs) and
equivariant dropout (whole channels); both are active only in
``train()`` mode, with masks drawn from the caller's ``torch.Generator``.

Sequence parallelism (``shard``: this rank's ``EdgeShard``,
parallel/sharding.py): HTR and the attention run on the rank's edges with
their weights whole (``ModelGroup.call_divergent``), the node features
entering through ``copy_to``; the attention's node rows are gathered
before the residual.  The FFN stays tensor-parallel on every node;
the dual stream's angular refinement runs on the rank's edges as HTR does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.irreps import IrrepsLayout
from ..ops.s2grid import S2Grid
from ..ops.segment import gather_nodes
from ..utils.trace import span
from .attention import GraphAttention
from .dual_stream import AngularHTR, TensorProductFFN
from .ffn import ESENFeedForward, FeedForward
from .gata import HTR
from .layers import keep_mask
from .moe import MoEHTRFeedForward
from .norms import get_normalization_layer

FFN_VARIANTS = ("standard", "moe", "moe_breaking", "esen", "tensor_product")

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
                 normalize_attn_output: bool = True, use_phi_every_layer: bool = False,
                 norm_type: str = "rms_norm_sh", use_atom_edge_embedding: bool = True,
                 use_m_share_rad: bool = False, use_attn_renorm: bool = True,
                 use_gate_act: bool = False, use_grid_mlp: bool = False,
                 use_sep_s2_act: bool = True, gata_v1: bool = False,
                 ffn_variant: str = "standard", num_experts: int = 4,
                 dual_stream: bool = False, num_rbf: int | None = None):
        super().__init__()
        if ffn_variant not in FFN_VARIANTS:
            raise ValueError(f"ffn_variant={ffn_variant!r}: one of {FFN_VARIANTS}")
        lmax = layout_full.lmax
        self.gata, self.dual_stream = gata, gata and dual_stream
        self.ffn_variant = ffn_variant
        if gata:
            self.htr = HTR(sphere_channels, edge_channels, lmax)
            if dual_stream:
                self.angular_htr = AngularHTR(sphere_channels, edge_channels, lmax)
        self.attn_norm = get_normalization_layer(norm_type, lmax, sphere_channels)
        self.ga = GraphAttention(
            layout_full, layout_red, grid_red, sphere_channels, attn_hidden_channels,
            num_heads, attn_alpha_channels, attn_value_channels,
            sphere_channels, max_num_elements, edge_channels_list,
            edge_channels, alpha_drop, gata, conv_fused, normalize_attn_output,
            use_phi_every_layer, use_atom_edge_embedding=use_atom_edge_embedding,
            use_m_share_rad=use_m_share_rad, use_attn_renorm=use_attn_renorm,
            use_gate_act=use_gate_act, use_sep_s2_act=use_sep_s2_act, gata_v1=gata_v1,
            num_rbf=num_rbf,
        )
        self.drop_path = GraphDropPath(drop_path_rate)
        self.proj_drop = EquivariantDropout(proj_drop)
        self.ffn_norm = get_normalization_layer(norm_type, lmax, sphere_channels)
        if ffn_variant in ("moe", "moe_breaking"):
            self.ffn = MoEHTRFeedForward(sphere_channels, ffn_hidden_channels, edge_channels,
                                         lmax, num_experts, ffn_variant == "moe_breaking")
        elif ffn_variant == "esen":
            self.ffn = ESENFeedForward(sphere_channels, ffn_hidden_channels, sphere_channels,
                                       lmax)
        elif ffn_variant == "tensor_product":
            self.ffn = TensorProductFFN(sphere_channels, ffn_hidden_channels, edge_channels,
                                        lmax)
        else:
            self.ffn = FeedForward(sphere_channels, ffn_hidden_channels, sphere_channels,
                                   lmax, grid_full, use_gate_act=use_gate_act,
                                   use_grid_mlp=use_grid_mlp, use_sep_s2_act=use_sep_s2_act)
        self.mp = None

    def forward(self, x, atomic_numbers, edge_scalars, edge_src, edge_dst,
                edge_mask, wigner, t_ij, rl_ij, blocks, graph_idx,
                num_graphs: int, generator: Optional[torch.Generator] = None, phi_r=None,
                a_ij=None, shard=None, live=None):
        """Returns (x, t_ij, a_ij); ``t_ij`` is None without GATA-V2,
        ``rl_ij`` without GATA (V2 or v1), ``a_ij`` without the dual
        stream, ``phi_r`` (the distance RBF) without ``use_phi_every_layer``;
        ``shard``: sequence parallelism (module doc); ``live``: the attention's
        K3 weight gradients reduce rows ``[0, live)`` (models/backbone.py)."""
        sp = shard.mp if shard is not None else None
        with span("etq.model.attention"):
            if self.gata:
                xe = x if sp is None else sp.copy_to(x)
                X_i = gather_nodes(xe, edge_src, blocks)[:, 1:, :]
                X_j = gather_nodes(xe, edge_dst, blocks, canonical_dst=True,
                                   shard=shard)[:, 1:, :]
                if sp is None:
                    t_ij = self.htr(t_ij, X_i, X_j, rl_ij)
                else:
                    t_ij = sp.call_divergent(self.htr, t_ij, X_i, X_j, rl_ij)
                if self.dual_stream and sp is None:
                    a_ij = self.angular_htr(a_ij, t_ij, x, edge_src, edge_dst, edge_mask,
                                            blocks)
                elif self.dual_stream:
                    a_ij = sp.call_divergent(self.angular_htr, a_ij, t_ij, sp.copy_to(x),
                                             edge_src, edge_dst, edge_mask, blocks, shard=shard)
            args = (atomic_numbers, edge_scalars, edge_src, edge_dst, edge_mask, wigner, t_ij,
                    rl_ij, blocks, generator, phi_r)
            if sp is None:
                h = self.ga(self.attn_norm(x), *args, live=live)
            else:
                h = sp.gather(sp.call_divergent(self.ga, sp.copy_to(self.attn_norm(x)), *args,
                                                shard=shard), dim=0)
        h = self.drop_path(h, graph_idx, num_graphs, generator)
        x = x + self.proj_drop(h, generator)
        with span("etq.model.ffn"):
            h = self.ffn_norm(x)
            if self.ffn_variant in ("moe", "moe_breaking"):
                h = self.ffn(h, t_ij, edge_dst, edge_mask, blocks, shard=shard)
            elif self.ffn_variant == "tensor_product":
                h = self.ffn(h, t_ij, a_ij if a_ij is not None else t_ij, edge_dst, edge_mask,
                             blocks, shard=shard)
            else:
                h = self.ffn(h)
        h = self.drop_path(h, graph_idx, num_graphs, generator)
        x = x + self.proj_drop(h, generator)
        return x, t_ij, a_ij
