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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.irreps import IrrepsLayout
from ..ops.rotation import rotate_from_edge, rotate_to_edge, rotate_to_edge_m0
from ..ops.s2grid import S2Grid
from ..ops.segment import gather_dst, gather_nodes, softmax_over_slots, sum_over_slots
from .activations import gate_activation, s2_activation, separable_s2_activation
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
            extra_m0 = self.alpha_ch + lmax * hidden_channels
        elif use_sep_s2_act:
            # GATA: alpha + one gate per (l, m != 0 sign) stream; baseline:
            # alpha + the S2 activation's gating scalars
            extra_m0 = self.alpha_ch + ((1 + 2 * lmax) if any_gata else 1) * hidden_channels
        else:
            extra_m0 = self.alpha_ch
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
                                  m0_only=self.m0_only, conv_fused=conv_fused)
        self.alpha_norm = LayerNorm(attn_alpha_channels, eps=1e-5) if use_attn_renorm else None
        self.alpha_dot = nn.Parameter(torch.empty(num_heads, attn_alpha_channels))
        if self.m0_only and gata and not gata_v1:
            self.value_act = GATAValueActivation(
                sphere_channels, hidden_channels, edge_channels, lmax, layout_red.mmax,
                use_phi=use_phi_every_layer, num_rbf=num_rbf or edge_channels_list[0],
            )
        self.so2_conv_2 = SO2Conv(layout_red, hidden_channels,
                                  num_heads * attn_value_channels, conv_fused=conv_fused)
        self.proj = SO3Linear(num_heads * attn_value_channels, output_channels, lmax)

    def _alpha(self, x0_alpha, k: int, edge_mask):
        """Attention weights [E, heads]: the alpha LayerNorm, smooth leaky
        ReLU, the per-head dot and the softmax over each node's slots."""
        a = x0_alpha.reshape(-1, self.num_heads, self.attn_alpha_channels)
        if self.alpha_norm is not None:
            a = self.alpha_norm(a)
        a = smooth_leaky_relu(a)
        dt = torch.promote_types(a.dtype, self.alpha_dot.dtype)
        logits = torch.einsum("ehk,hk->eh", a.to(dt), self.alpha_dot.to(dt))
        return softmax_over_slots(logits, k, edge_mask)

    def forward(self, x, atomic_numbers, edge_scalars, edge_src, edge_dst,
                edge_mask, wigner, t_ij, rl_ij, k: int,
                generator: Optional[torch.Generator] = None, phi_r=None):
        """Fixed-degree layout: k edge slots per node (ops/segment.py).
        ``t_ij`` / ``rl_ij``: the GATA edge streams (None when unused);
        ``phi_r``: the distance RBF (``use_phi_every_layer`` only)."""
        x_edge = edge_scalars
        if self.use_atom_edge_embedding:
            x_edge = torch.cat([edge_scalars,
                                self.src_embedding(atomic_numbers[edge_src]),
                                self.dst_embedding(atomic_numbers[edge_dst])], dim=1)
        x_src = gather_nodes(x, edge_src)
        x_dst = gather_dst(x, k)
        # unrotated target-node features (reference Gotennet fork
        # transformer_block.py:255-267 gathers the target embedding)
        h_j, X_j = x_dst[:, 0, :], x_dst[:, 1:, :]
        msg = torch.cat([x_src, x_dst], dim=2)            # [E, K_full, 2C]
        if self.rad is not None:   # m-share radial scale, one per degree
            w = self.rad(x_edge).reshape(msg.shape[0], self.lmax + 1, -1)
            msg = msg * w[:, self.expand, :]
        if self.m0_only:
            msg = rotate_to_edge_m0(wigner, msg, self.layout_red)
        else:
            msg = rotate_to_edge(wigner, msg, self.layout_red)
        msg, x0_extra = self.so2_conv_1(msg, None if self.rad is not None else x_edge)
        alpha_in, rest = x0_extra[:, : self.alpha_ch], x0_extra[:, self.alpha_ch :]
        if self.use_gate_act:
            msg = gate_activation(rest, msg, self.lmax, self.layout_red.mmax,
                                  self.hidden_channels)
            alpha = self._alpha(alpha_in, k, edge_mask)
        elif not self.use_sep_s2_act:
            msg = s2_activation(msg, self.grid_red)
            alpha = self._alpha(x0_extra, k, edge_mask)
        elif self.gata_v1:
            # gates straight from conv 1, no t_ij bias, no alpha scaling
            # (reference Gotennet_inspired/transformer_block.py:311-325)
            msg = gata_value_activation_v1(rest, X_j, rl_ij, self.lmax, self.hidden_channels)
            alpha = self._alpha(alpha_in, k, edge_mask)
        elif self.gata:
            # alpha before the value activation (reference fork :315-324)
            alpha = self._alpha(alpha_in, k, edge_mask)
            if self.normalize_attn_output:   # by the head-mean of alpha
                rest = rest * alpha.mean(dim=1, keepdim=True).to(rest.dtype)
            msg = self.value_act(rest, t_ij, h_j, X_j, rl_ij, phi_r)
        else:
            msg = separable_s2_activation(rest, msg, self.grid_red)
            alpha = self._alpha(alpha_in, k, edge_mask)

        msg, _ = self.so2_conv_2(msg, None)
        if self.alpha_drop > 0.0 and self.training:
            keep = 1.0 - self.alpha_drop
            alpha = alpha * keep_mask(alpha.shape, keep, generator,
                                      alpha.device).to(alpha.dtype) / keep
        E, Kr = msg.shape[0], msg.shape[1]
        msg = msg.reshape(E, Kr, self.num_heads, self.attn_value_channels)
        msg = (msg * alpha[:, None, :, None].to(msg.dtype)).reshape(E, Kr, -1)

        msg = rotate_from_edge(wigner, msg, self.layout_red)
        return self.proj(sum_over_slots(msg, k, edge_mask))
