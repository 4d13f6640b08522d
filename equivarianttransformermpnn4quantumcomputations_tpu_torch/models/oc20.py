"""EquiformerV2 for OC20 S2EF: energy head + explicit per-atom force head.

Port of the JAX package's models/oc20.py (``EquiformerV2OC20``; reference
equiformerv2_oc20.py:63-306):

* energy: a ``FeedForward`` head read at l = 0, channel 0, summed over each
  graph's atoms and divided by the OC20 average node count;
* forces: one baseline ``GraphAttention`` block with a single output
  channel on the backbone's features, edge scalars and Wigner rotation; the
  Cartesian force is read off the l = 1 coefficients, which the real-SH
  basis orders (m = -1, 0, +1) ~ (y, z, x): the gather (3, 1, 2) gives
  (x, y, z).  Forces are masked to real atoms.

The backbone is the baseline EquiformerV2 (``gata=False``, separable S2
activations, default S2 grid).  ``wigner_rep`` chooses its Wigner
representation: ``"factored"`` is what the JAX package resolves to off a
TPU and what ``configs/oc20.py`` builds (kernel K4 on the card);
``"dense"`` runs kernel K1.  ``conv_fused`` sends the SO(2)-conv sites
through kernel K3 (off by default, as in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.attention import GraphAttention
from ..nn.ffn import FeedForward
from ..ops.irreps import layout as get_layout
from ..ops.s2grid import s2grid
from ..ops.segment import segment_sum
from ..utils.trace import span, sync
from .backbone import BACKBONE_OPTIONS, EquiformerV2Backbone
from .qm9 import HEAD_OPTIONS, check_options

__all__ = ["EquiformerV2OC20", "AVG_NUM_NODES_OC20", "AVG_DEGREE_OC20"]

AVG_NUM_NODES_OC20 = 77.81317
AVG_DEGREE_OC20 = 23.395238876342773


class EquiformerV2OC20(nn.Module):
    """Backbone + energy head + force head (the JAX package's defaults:
    12 layers, 128 channels, lmax 6 / mmax 2, 8 heads, FFN 512, 600 RBF,
    cutoff 12).  Dropouts act only in ``train()`` mode; ``compute_dtype``
    is the block stack's type (the heads read the float32 backbone output).
    ``options``: the backbone options of ``models/qm9.py:BASELINE_OPTIONS``;
    the force block takes the attention's.  ``uniform_blocks`` /
    ``fixed_degree``: the batch layout; ``remat``: each block
    rematerialized in every backward (models/backbone.py)."""

    def __init__(self, num_layers: int = 12, sphere_channels: int = 128,
                 attn_hidden_channels: int = 128, num_heads: int = 8,
                 attn_alpha_channels: int = 32, attn_value_channels: int = 16,
                 ffn_hidden_channels: int = 512, lmax: int = 6, mmax: int = 2,
                 grid_resolution: int | None = None, edge_channels: int = 128,
                 num_rbf: int = 600, max_num_elements: int = 90, cutoff: float = 12.0,
                 alpha_drop: float = 0.1, drop_path_rate: float = 0.05,
                 proj_drop: float = 0.0, avg_num_nodes: float = AVG_NUM_NODES_OC20,
                 avg_degree: float = AVG_DEGREE_OC20,
                 compute_dtype: torch.dtype = torch.float32, conv_fused: bool = False,
                 wigner_rep: str = "factored", uniform_blocks: bool = False,
                 fixed_degree: bool = False, remat: bool = False, **options):
        super().__init__()
        check_options(options)
        opt = {**BACKBONE_OPTIONS, **options}
        self.avg_num_nodes = avg_num_nodes
        self.backbone = EquiformerV2Backbone(
            num_layers=num_layers, sphere_channels=sphere_channels,
            attn_hidden_channels=attn_hidden_channels, num_heads=num_heads,
            attn_alpha_channels=attn_alpha_channels,
            attn_value_channels=attn_value_channels,
            ffn_hidden_channels=ffn_hidden_channels, lmax=lmax, mmax=mmax,
            grid_resolution=grid_resolution, edge_channels=edge_channels,
            num_rbf=num_rbf, max_num_elements=max_num_elements, cutoff=cutoff,
            avg_degree=avg_degree, alpha_drop=alpha_drop,
            drop_path_rate=drop_path_rate, proj_drop=proj_drop,
            compute_dtype=compute_dtype, gata=False, conv_fused=conv_fused,
            wigner_rep=wigner_rep, uniform_blocks=uniform_blocks, fixed_degree=fixed_degree,
            remat=remat, **options,
        )
        self.energy_block = FeedForward(sphere_channels, ffn_hidden_channels, 1, lmax,
                                        s2grid(lmax, lmax, grid_resolution),
                                        **{k: opt[k] for k in HEAD_OPTIONS})
        # the backbone's edge scalars carry the shared atom-edge embeddings
        share = opt["share_atom_edge_embedding"] and opt["use_atom_edge_embedding"]
        self.force_block = GraphAttention(
            get_layout(lmax, lmax), get_layout(lmax, mmax), s2grid(lmax, mmax, grid_resolution),
            sphere_channels, attn_hidden_channels, num_heads, attn_alpha_channels,
            attn_value_channels, 1, max_num_elements,
            (num_rbf + (2 * edge_channels if share else 0), edge_channels, edge_channels),
            edge_channels, alpha_drop, gata=False, conv_fused=conv_fused,
            use_atom_edge_embedding=opt["use_atom_edge_embedding"] and not share,
            use_m_share_rad=opt["use_m_share_rad"], use_attn_renorm=opt["use_attn_renorm"],
            use_gate_act=opt["use_gate_act"], use_sep_s2_act=opt["use_sep_s2_act"],
        )

    def forward(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        """batch: ``data/graph.py:as_tensors`` of a collated batch.  Returns
        energy [B] and forces [N, 3] (normalized units)."""
        out = self.backbone(
            batch["atomic_numbers"], batch["pos"], batch["graph_idx"],
            batch["edge_src"], batch["edge_dst"], batch["edge_shift"],
            batch["edge_mask"], batch["cell"], generator,
        )
        with span("etq.model.head"):
            node_energy = self.energy_block(out.x)[:, 0, 0]
            energy = segment_sum(node_energy, batch["graph_idx"], batch["cell"].shape[0],
                                 mask=batch["node_mask"]) / self.avg_num_nodes
            f = self.force_block(out.x, batch["atomic_numbers"], out.edge_scalars,
                                 batch["edge_src"], batch["edge_dst"], batch["edge_mask"],
                                 out.wigner, None, None, out.blocks, generator)
            # l = 1 coefficients (m = -1, 0, +1) ~ (y, z, x) -> Cartesian (x, y, z)
            with sync("force_index"):
                forces = f[:, [3, 1, 2], 0]
        return {"energy": energy,
                "forces": forces * batch["node_mask"][:, None].to(forces.dtype)}
