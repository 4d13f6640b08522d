"""SO(2)-equivariant graph attention: the baseline EquiformerV2, GATA-V2
and GATA v1 paths.

Port of the JAX package's nn/attention.py, every configuration of it:

  gather src/dst features -> concat (2C) -> [m-share radial scale] ->
  rotate into the edge frame -> SO(2) conv 1 (extra m=0 outputs: alpha +
  gates) -> {gate | separable-S2 | S2 | GATA-V2 | GATA v1} value activation
  -> SO(2) conv 2 -> alpha-weighted values -> rotate back -> segment sum ->
  per-degree proj.

GATA (V2 and v1): the value activation rebuilds its message from the
unrotated X_j and reads only the m = 0 block of the rotated message, so
only that block is rotated and convolved (the JAX package's default
``m0_only``; exactly equal to the full path).  Baseline: the full message
is rotated and convolved, and the value activation is the separable S2
activation on the reduced grid (kernel K2 at the edge site), gated by the
extra m = 0 channels, or the gate activation (``use_gate_act``) or the
plain S2 activation (``use_sep_s2_act=False``, K2 too).
``conv_fused`` sends every full SO(2)-conv site through kernel K3.
GATA-V2 options: ``normalize_attn_output`` (on by default) scales the value
activation's input by the head-mean of alpha; ``use_phi_every_layer`` feeds
the distance RBF ``phi_r`` to the value activation's bias.  GATA v1
(``gata_v1``) takes its gates straight from conv 1 and needs
mmax == lmax and hidden_channels == sphere_channels.
Other options: ``use_atom_edge_embedding`` (per-block atom embeddings in
the edge scalars), ``use_m_share_rad`` (one radial scale per degree on the
message instead of conv 1's radial MLP), ``use_attn_renorm`` (the alpha
LayerNorm).

Tensor parallelism (the JAX package's roles): ``so2_conv_1`` column,
``so2_conv_2`` and ``proj`` row.  With a ``ModelGroup`` (``mp``,
parallel/sharding.py) conv 1 gives the rank the alpha logits of its
num_heads / M heads and its C/M channels of every gate chunk and degree;
alpha is computed on the rank's heads (the alpha norm and ``alpha_dot``
replicated, the GATA head-mean of alpha by one ``reduce_from``); the value
activation runs on the rank's channels; conv 2's partial sums are
reduce-scattered onto the rank's heads (whole heads: 128 = 8 x 16 splits
into contiguous halves), so the alpha weighting, the dropout, the rotation
back (kernel K1 at [E, K_red, 128 / M]) and the slot sum run on them;
``proj`` closes the block with one ``reduce_from``.  Under sequence
parallelism the module runs unpartitioned on its rank's edges, called
through ``ModelGroup.call_divergent``; ``shard`` (``EdgeShard``) then
names them and the node rows whose complete sums the rank takes: the
softmax and the sum onto the targets run over every rank's edges
(ops/segment.py), and ``proj`` runs on the rank's rows.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.irreps import IrrepsLayout
from ..ops.rotation import rotate_from_edge, rotate_to_edge, rotate_to_edge_m0
from ..ops.s2grid import S2Grid
from ..ops.segment import gather_nodes, segment_softmax, segment_sum
from .activations import gate_activation, s2_activation, separable_s2_activation
from .embedding import atom_edge_features
from .gata import GATAValueActivation, gata_value_activation_v1
from .layers import LayerNorm, RadialMLP, keep_mask, smooth_leaky_relu
from .so3_layers import SO2Conv, SO3Linear

__all__ = ["GraphAttention"]


class GraphAttention(nn.Module):
    def __init__(self, layout_full: IrrepsLayout, layout_red: IrrepsLayout,
                 grid_red: S2Grid, sphere_channels: int, hidden_channels: int,
                 num_heads: int, attn_alpha_channels: int,
                 attn_value_channels: int, output_channels: int,
                 max_num_elements: int, edge_channels_list: Sequence[int],
                 edge_channels: int, alpha_drop: float = 0.0, gata: bool = True,
                 conv_fused: bool = False, normalize_attn_output: bool = True,
                 use_phi_every_layer: bool = False, use_atom_edge_embedding: bool = True,
                 use_m_share_rad: bool = False, use_attn_renorm: bool = True,
                 use_gate_act: bool = False, use_sep_s2_act: bool = True,
                 gata_v1: bool = False, num_rbf: int | None = None):
        super().__init__()
        lmax = layout_full.lmax
        self.lmax = lmax
        self.alpha_drop = alpha_drop
        self.gata, self.gata_v1 = gata, gata_v1
        self.normalize_attn_output = normalize_attn_output
        self.use_atom_edge_embedding = use_atom_edge_embedding
        self.use_gate_act, self.use_sep_s2_act = use_gate_act, use_sep_s2_act
        self.layout_red, self.grid_red = layout_red, grid_red
        self.num_heads = num_heads
        self.hidden_channels = hidden_channels
        self.alpha_ch = num_heads * attn_alpha_channels
        self.attn_alpha_channels = attn_alpha_channels
        self.attn_value_channels = attn_value_channels
        ec = list(edge_channels_list)
        if use_atom_edge_embedding:
            self.src_embedding = nn.Embedding(max_num_elements, ec[-1])
            self.dst_embedding = nn.Embedding(max_num_elements, ec[-1])
            ec[0] += 2 * ec[-1]
        self.rad = None
        if use_m_share_rad:
            self.rad = RadialMLP(tuple(ec) + (2 * sphere_channels * (lmax + 1),))
            self.register_buffer("expand", torch.as_tensor(layout_full.l_harmonic,
                                                           dtype=torch.long),
                                 persistent=False)
        any_gata = gata or gata_v1
        # GATA: the value path reads only the m = 0 outputs of conv 1
        self.m0_only = any_gata and use_sep_s2_act and not use_gate_act
        if use_gate_act:
            n_gates = lmax
        elif use_sep_s2_act:
            # GATA: alpha + one gate per (l, m != 0 sign) stream; baseline:
            # alpha + the S2 activation's gating scalars
            n_gates = (1 + 2 * lmax) if any_gata else 1
        else:
            n_gates = 0
        extra_chunks = [self.alpha_ch] + [hidden_channels] * n_gates
        extra_m0 = sum(extra_chunks)
        if self.m0_only and gata_v1:
            if layout_red.mmax != lmax:
                raise ValueError("gata_v1 requires mmax == lmax (full-width value act; "
                                 "reference config_cosinelearningGATA.py:110)")
            if hidden_channels != sphere_channels:
                raise ValueError("gata_v1 requires attn_hidden_channels == sphere_channels "
                                 "(unprojected X_j)")
        self.so2_conv_1 = SO2Conv(layout_red, 2 * sphere_channels, hidden_channels,
                                  extra_m0=extra_m0,
                                  rad_channels=None if use_m_share_rad else tuple(ec),
                                  m0_only=self.m0_only, conv_fused=conv_fused, tp="col",
                                  extra_chunks=extra_chunks)
        self.alpha_norm = LayerNorm(attn_alpha_channels, eps=1e-5) if use_attn_renorm else None
        self.alpha_dot = nn.Parameter(torch.empty(num_heads, attn_alpha_channels))
        if self.m0_only and gata and not gata_v1:
            self.value_act = GATAValueActivation(
                sphere_channels, hidden_channels, edge_channels, lmax, layout_red.mmax,
                use_phi=use_phi_every_layer, num_rbf=num_rbf or edge_channels_list[0],
            )
        self.so2_conv_2 = SO2Conv(layout_red, hidden_channels,
                                  num_heads * attn_value_channels, conv_fused=conv_fused,
                                  tp="row")
        self.proj = SO3Linear(num_heads * attn_value_channels, output_channels, lmax,
                              tp="row")
        self.mp = None

    def _alpha(self, x0_alpha, edge_dst, num_nodes: int, edge_mask, blocks, shard=None):
        """Attention weights [E, heads] (the rank's heads under TP): the
        alpha LayerNorm, smooth leaky ReLU, the per-head dot and the softmax
        over each node's slots."""
        mp = self.mp
        heads = self.num_heads // (mp.size if mp is not None else 1)
        a = x0_alpha.reshape(-1, heads, self.attn_alpha_channels)
        dot = self.alpha_dot
        if mp is not None:   # replicated parameters on the rank's heads
            dot = mp.copy_to(dot)[mp.part(self.num_heads)]
        if self.alpha_norm is not None:
            a = self.alpha_norm(a) if mp is None else mp.call_divergent(self.alpha_norm, a)
        a = smooth_leaky_relu(a)
        dt = torch.promote_types(a.dtype, dot.dtype)
        logits = torch.einsum("ehk,hk->eh", a.to(dt), dot.to(dt))
        return segment_softmax(logits, edge_dst, num_nodes, mask=edge_mask, blocks=blocks,
                               fixed_dst=True, shard=shard)

    def forward(self, x, atomic_numbers, edge_scalars, edge_src, edge_dst,
                edge_mask, wigner, t_ij, rl_ij, blocks=None,
                generator: Optional[torch.Generator] = None, phi_r=None, shard=None,
                live=None):
        """``blocks``: the batch layout (ops/segment.py; None: ragged).
        ``t_ij`` / ``rl_ij``: the GATA edge streams (None when unused);
        ``phi_r``: the distance RBF (``use_phi_every_layer`` only);
        ``shard``: the edges are this rank's (sequence parallelism; ``x`` is
        every node, the output holds the rank's node rows); ``live``: the
        rows past which the edges take zero gradients (models/backbone.py),
        for K3's weight gradient."""
        mp = self.mp
        x_edge = edge_scalars
        if self.use_atom_edge_embedding:
            x_edge = atom_edge_features(edge_scalars, self.src_embedding, self.dst_embedding,
                                        atomic_numbers, edge_src, edge_dst, blocks, shard)
        num_nodes = x.shape[0]
        x_src = gather_nodes(x, edge_src, blocks)
        x_dst = gather_nodes(x, edge_dst, blocks, canonical_dst=True, shard=shard)
        # unrotated target-node features (reference Gotennet fork
        # transformer_block.py:255-267 gathers the target embedding); under
        # TP the value path's share, copied in at the nodes
        gata_value = mp is not None and (self.gata or self.gata_v1)
        x_val = (gather_nodes(mp.copy_to(x), edge_dst, blocks, canonical_dst=True)
                 if gata_value else x_dst)
        h_j, X_j = x_val[:, 0, :], x_val[:, 1:, :]
        msg = torch.cat([x_src, x_dst], dim=2)            # [E, K_full, 2C]
        if self.rad is not None:   # m-share radial scale, one per degree
            w = self.rad(x_edge).reshape(msg.shape[0], self.lmax + 1, -1)
            msg = msg * w[:, self.expand, :]
        if self.m0_only:
            msg = rotate_to_edge_m0(wigner, msg, self.layout_red)
        else:
            msg = rotate_to_edge(wigner, msg, self.layout_red)
        msg, x0_extra = self.so2_conv_1(msg, None if self.rad is not None else x_edge,
                                        live=live)
        a_ch = self.alpha_ch // (mp.size if mp is not None else 1)
        alpha_in, rest = x0_extra[:, :a_ch], x0_extra[:, a_ch:]
        if self.use_gate_act:
            msg = gate_activation(rest, msg, self.lmax, self.layout_red.mmax,
                                  msg.shape[-1])
            alpha = self._alpha(alpha_in, edge_dst, num_nodes, edge_mask, blocks, shard)
        elif not self.use_sep_s2_act:
            msg = s2_activation(msg, self.grid_red)
            alpha = self._alpha(x0_extra, edge_dst, num_nodes, edge_mask, blocks, shard)
        elif self.gata_v1:
            # gates straight from conv 1, no t_ij bias, no alpha scaling
            # (reference Gotennet_inspired/transformer_block.py:311-325)
            C = self.hidden_channels
            if mp is not None:   # the rank's channels of the unprojected X_j
                C //= mp.size
                X_j = X_j[..., mp.part(self.hidden_channels)]
            msg = gata_value_activation_v1(rest, X_j, rl_ij, self.lmax, C)
            alpha = self._alpha(alpha_in, edge_dst, num_nodes, edge_mask, blocks, shard)
        elif self.gata:
            # alpha before the value activation (reference fork :315-324)
            alpha = self._alpha(alpha_in, edge_dst, num_nodes, edge_mask, blocks, shard)
            if self.normalize_attn_output:   # by the head-mean of alpha
                if mp is None:
                    mean = alpha.mean(dim=1, keepdim=True)
                else:
                    mean = mp.copy_to(mp.reduce_from(alpha.sum(dim=1, keepdim=True))
                                      / self.num_heads)
                rest = rest * mean.to(rest.dtype)
            msg = self.value_act(rest, t_ij, h_j, X_j, rl_ij, phi_r, copied=mp is not None)
        else:
            msg = separable_s2_activation(rest, msg, self.grid_red)
            alpha = self._alpha(alpha_in, edge_dst, num_nodes, edge_mask, blocks, shard)

        msg, _ = self.so2_conv_2(msg, None, scatter=mp is not None, live=live)
        if self.alpha_drop > 0.0 and self.training:
            # the whole batch's mask, as one process draws it
            keep = 1.0 - self.alpha_drop
            n_edges = alpha.shape[0] * (1 if shard is None else shard.mp.size)
            mask = keep_mask((n_edges, self.num_heads), keep, generator, alpha.device)
            if shard is not None:
                mask = mask[shard.edges]
            if mp is not None:
                mask = mask[:, mp.part(self.num_heads)]
            alpha = alpha * mask.to(alpha.dtype) / keep
        E, Kr = msg.shape[0], msg.shape[1]
        msg = msg.reshape(E, Kr, alpha.shape[1], self.attn_value_channels)
        msg = (msg * alpha[:, None, :, None].to(msg.dtype)).reshape(E, Kr, -1)

        msg = rotate_from_edge(wigner, msg, self.layout_red)
        return self.proj(segment_sum(msg, edge_dst, num_nodes, mask=edge_mask, sorted_ids=True,
                                     blocks=blocks, fixed_dst=True, shard=shard))
