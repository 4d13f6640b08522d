"""Dual-stream variant: a three-body angular edge stream and the
tensor-product FFN.

Port of the JAX package's nn/dual_stream.py (reference models/NewFunctions/
GATA_and_all2all_Dual_Stream/activation.py:1363-1484 AngularHTR;
transformer_block.py:375-460 TensorProductFFN).  Two invariant edge streams
run through the blocks: ``t_ij`` (pairwise, HTR-refined) and ``a_ij``
(angular, three-body).  Any edge layout (``blocks``, ops/segment.py).

Neither module has a tensor-parallel role.  Under sequence parallelism
(``shard``: the edges are this rank's, parallel/sharding.py) the angular
stream's sums onto the edges' source nodes (the segment-id layout) are
each rank's partial sums, summed over the ranks with ``reduce_from``, and
the tensor-product FFN's node means of the rank's rows (completed over the
ranks, ops/segment.py) are gathered.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.segment import gather_nodes, segment_mean, segment_sum
from .layers import LayerNorm, Linear
from .norms import EquivariantRMSNormSH

__all__ = ["AngularHTR", "TensorProductFFN"]


class AngularHTR(nn.Module):
    """Three-body refinement of the angular stream a_ij: degree-wise inner
    products of the projected target features with the mean of the
    neighbour keys scattered at the source node, gated by t_ij, added to
    a_ij (reference activation.py:1363-1484, including its projection of
    the *target* features for both the query and the key side)."""

    def __init__(self, sphere_channels: int, edge_channels: int, lmax: int):
        super().__init__()
        self.lmax = lmax
        self.x_norm = EquivariantRMSNormSH(lmax, sphere_channels)
        self.t_norm = LayerNorm(edge_channels, eps=1e-5)
        for l in range(1, lmax + 1):
            setattr(self, f"W_q_{l}", Linear(sphere_channels, edge_channels, bias=False))
            setattr(self, f"W_k_{l}", Linear(sphere_channels, edge_channels, bias=False))
        self.t_proj = Linear(edge_channels, edge_channels, bias=False)
        self.gamma_w = Linear(edge_channels, edge_channels)
        self.gamma_a_1 = Linear(edge_channels, edge_channels)
        self.gamma_a_2 = Linear(edge_channels, edge_channels)
        self.mp = None

    def forward(self, a_ij, t_ij, x, edge_src, edge_dst, edge_mask, blocks=None, shard=None):
        """a_ij / t_ij: [E, edge_C]; x: [N, K, C] (the block's input);
        ``blocks``: the batch layout (ops/segment.py)."""
        N, E = x.shape[0], a_ij.shape[0]
        X_all = self.x_norm(x)[:, 1:, :]

        def source_sum(v):   # onto the source nodes; every rank's edges under SP
            out = segment_sum(v, edge_src, N, mask=edge_mask)
            return out if shard is None else shard.mp.copy_to(shard.mp.reduce_from(out))

        t_n = self.t_norm(t_ij)
        # edges per source node, at least 1 (reference :1433-1436)
        deg = torch.clamp(source_sum(a_ij.new_ones(E)), min=1.0)
        w_ang = a_ij.new_zeros(E, a_ij.shape[1])
        offset = 0
        for l in range(1, self.lmax + 1):
            d = 2 * l + 1
            Xl_dst = gather_nodes(X_all[:, offset : offset + d, :], edge_dst, blocks,
                                  canonical_dst=True, shard=shard)
            offset += d
            q = getattr(self, f"W_q_{l}")(Xl_dst)
            kk = getattr(self, f"W_k_{l}")(Xl_dst)
            agg_k = source_sum(kk) / deg[:, None, None]
            w_ang = w_ang + (q * gather_nodes(agg_k, edge_src, blocks)).sum(1) / d
        w_ang = w_ang * self.t_proj(t_n)
        gw = F.silu(self.gamma_w(w_ang))
        ga = F.silu(self.gamma_a_2(F.silu(self.gamma_a_1(a_ij))))
        return a_ij + gw * ga


class TensorProductFFN(nn.Module):
    """FFN whose per-degree gates see [c_i, c_i angular, |X^(l)|, x0]
    (reference transformer_block.py:375-460)."""

    def __init__(self, sphere_channels: int, hidden_channels: int, edge_channels: int,
                 lmax: int):
        super().__init__()
        self.lmax = lmax
        self.linear_1 = Linear(sphere_channels, hidden_channels, bias=False)
        for l in range(lmax + 1):
            setattr(self, f"gate_{l}_1",
                    Linear(2 * edge_channels + 2 * sphere_channels, hidden_channels))
            setattr(self, f"gate_{l}_2", Linear(hidden_channels, hidden_channels))
        self.linear_2 = Linear(hidden_channels, sphere_channels, bias=False)
        self.mp = None

    def forward(self, x, t_ij, a_ij, edge_dst, edge_mask, blocks=None, shard=None):
        def node_mean(v):   # the rank's node rows gathered under SP
            m = segment_mean(v, edge_dst, x.shape[0], mask=edge_mask, blocks=blocks,
                             fixed_dst=True, shard=shard)
            m = m if shard is None else shard.mp.gather(m, dim=0)
            return torch.nan_to_num(m, nan=0.0, posinf=1.0, neginf=-1.0)

        c_i, c_a = node_mean(t_ij), node_mean(a_ij)
        x0 = x[:, 0, :]
        h = self.linear_1(x)
        out = []
        for l in range(self.lmax + 1):
            sl = slice(l * l, (l + 1) ** 2)
            feat = x[:, sl, :]
            norm_l = torch.sqrt(torch.clamp((feat * feat).sum(1), min=1e-12))
            g = F.silu(getattr(self, f"gate_{l}_1")(torch.cat([c_i, c_a, norm_l, x0], -1)))
            g = F.silu(getattr(self, f"gate_{l}_2")(g))
            hl = h[:, sl, :]
            out.append((F.silu(hl) if l == 0 else hl) * g[:, None, :])
        return self.linear_2(torch.cat(out, dim=1))
