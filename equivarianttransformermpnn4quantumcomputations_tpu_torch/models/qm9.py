"""EquiformerV2 for QM9: 12 molecular scalar property heads.

Port of the JAX package's models/qm9.py (``EquiformerV2QM9`` with its
default ``vmap_heads=True``): the baseline EquiformerV2 backbone
(``gata=False``, separable S2 activations, default S2 grid), then one
``FeedForward`` head per target with weights stacked on a leading target
axis (nn/ffn.py:FeedForward with ``num``), each reading its l = 0, channel 0
output, masked-summed over each molecule's atoms with no division by the
atom count (reference equiformerv2_qm9.py:664-697).  Molecules have no
periodic cell: collate gives them the identity cell and zero shifts.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.ffn import FeedForward
from ..ops.s2grid import s2grid
from ..ops.segment import segment_sum
from .backbone import EquiformerV2Backbone

__all__ = ["EquiformerV2QM9", "BASELINE_OPTIONS"]

# the backbone options of the JAX package's QM9 and OC20 models
# (models/qm9.py:37-44); the heads take the three activation options
BASELINE_OPTIONS = ("norm_type", "use_gate_act", "use_grid_mlp", "use_sep_s2_act",
                    "use_m_share_rad", "use_attn_renorm", "use_atom_edge_embedding",
                    "share_atom_edge_embedding")
HEAD_OPTIONS = ("use_gate_act", "use_grid_mlp", "use_sep_s2_act")


def check_options(options: dict) -> None:
    unknown = set(options) - set(BASELINE_OPTIONS)
    if unknown:
        raise TypeError(f"unknown model options {sorted(unknown)}")


class EquiformerV2QM9(nn.Module):
    """Backbone + stacked target heads (the JAX package's defaults, which
    are ``configs/qm9.py:config``'s widths).

    ``conv_fused`` sends every SO(2)-conv site through kernel K3 (off by
    default, as the JAX package's ``KernelFlags.conv_fused``).  Dropouts act
    only in ``train()`` mode; ``compute_dtype`` is the block stack's type.
    ``wigner_rep``, ``uniform_blocks``, ``fixed_degree`` and ``remat`` are
    the backbone's (models/backbone.py).  ``options``: the backbone options of
    ``BASELINE_OPTIONS``.
    """

    def __init__(self, num_targets: int = 12, num_layers: int = 8,
                 sphere_channels: int = 128, attn_hidden_channels: int = 128,
                 num_heads: int = 8, attn_alpha_channels: int = 32,
                 attn_value_channels: int = 16, ffn_hidden_channels: int = 512,
                 lmax: int = 4, mmax: int = 2, grid_resolution: int | None = None,
                 edge_channels: int = 128, num_rbf: int = 600,
                 max_num_elements: int = 10, cutoff: float = 5.0,
                 avg_degree: float = 6.0, alpha_drop: float = 0.1,
                 drop_path_rate: float = 0.05, proj_drop: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_fused: bool = False, wigner_rep: str = "dense",
                 uniform_blocks: bool = False, fixed_degree: bool = False,
                 remat: bool = False, **options):
        super().__init__()
        check_options(options)
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
        self.output_blocks = FeedForward(
            sphere_channels, ffn_hidden_channels, 1, lmax, s2grid(lmax, lmax, grid_resolution),
            num=num_targets, **{k: options[k] for k in HEAD_OPTIONS if k in options},
        )

    def forward(self, batch: dict, generator: torch.Generator | None = None):
        """batch: ``data/graph.py:as_tensors`` of a collated batch.
        Returns the predictions [B, num_targets] (normalized units)."""
        x = self.backbone(
            batch["atomic_numbers"], batch["pos"], batch["graph_idx"],
            batch["edge_src"], batch["edge_dst"], batch["edge_shift"],
            batch["edge_mask"], batch["cell"], generator,
        ).x
        node_c = self.output_blocks(x)[:, :, 0, 0]       # [T, N]
        return segment_sum(node_c.t(), batch["graph_idx"], batch["cell"].shape[0],
                           mask=batch["node_mask"])
