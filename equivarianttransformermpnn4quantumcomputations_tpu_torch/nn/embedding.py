"""Edge-degree structure embedding (port of the JAX package's nn/embedding.py).

An invariant radial MLP emits the m = 0 coefficients in the edge frame, the
other orders are zero, the result is rotated back to the global frame and
summed onto the target nodes, scaled by 1/avg_degree (reference
input_block.py:17-131).  With ``use_atom_edge_embedding`` the radial
MLP's input carries the source and target atoms' embeddings.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.irreps import IrrepsLayout
from ..ops.rotation import rotate_from_edge
from ..ops.segment import gather_nodes, segment_sum
from .layers import RadialMLP

__all__ = ["EdgeDegreeEmbedding", "atom_edge_features"]


def atom_edge_features(edge_scalars: torch.Tensor, src_embedding: nn.Embedding,
                       dst_embedding: nn.Embedding, atomic_numbers: torch.Tensor,
                       edge_src: torch.Tensor, edge_dst: torch.Tensor, blocks=None,
                       shard=None) -> torch.Tensor:
    """The edge scalars with the source and target atoms' embeddings beside
    them: each embedding looked up per node, then gathered to the edges as
    the node features are (``ops/segment.py:gather_nodes``, in the layout of
    ``blocks``, the targets of a ``shard``'s rows).  Both gathers add their
    backward in a fixed order; the CUDA backward of ``nn.Embedding`` at the
    edges (over 3,072 indices) does not, and made two bf16 force-training
    gradients from one state differ in the embedding's weight."""
    src = gather_nodes(gather_nodes(src_embedding.weight, atomic_numbers), edge_src, blocks)
    dst = gather_nodes(gather_nodes(dst_embedding.weight, atomic_numbers), edge_dst, blocks,
                       canonical_dst=True, shard=shard)
    return torch.cat([edge_scalars, src, dst], dim=1)


class EdgeDegreeEmbedding(nn.Module):
    def __init__(self, sphere_channels: int, layout_red: IrrepsLayout,
                 max_num_elements: int, edge_channels_list: Sequence[int],
                 rescale_factor: float, use_atom_edge_embedding: bool = True):
        super().__init__()
        self.sphere_channels = sphere_channels
        self.layout = layout_red
        self.rescale_factor = rescale_factor
        self.use_atom_edge_embedding = use_atom_edge_embedding
        ec = list(edge_channels_list)
        if use_atom_edge_embedding:
            self.src_embedding = nn.Embedding(max_num_elements, ec[-1])
            self.dst_embedding = nn.Embedding(max_num_elements, ec[-1])
            ec[0] += 2 * ec[-1]
        self.L0 = int(layout_red.m_size[0])
        self.rad = RadialMLP(tuple(ec) + (self.L0 * sphere_channels,))
        self.register_buffer("from_m", torch.as_tensor(layout_red.from_m_perm,
                                                       dtype=torch.long),
                             persistent=False)

    def forward(self, atomic_numbers, edge_scalars, edge_src, edge_dst, edge_mask,
                wigner, blocks=None, shard=None) -> torch.Tensor:
        """The sum onto the edges' targets in the layout of ``blocks``
        (ops/segment.py); under sequence parallelism (``shard``) the edges
        are the rank's, and the output holds the complete sums of its node
        rows."""
        x_edge = edge_scalars
        if self.use_atom_edge_embedding:
            x_edge = atom_edge_features(edge_scalars, self.src_embedding, self.dst_embedding,
                                        atomic_numbers, edge_src, edge_dst, blocks, shard)
        m0 = self.rad(x_edge).reshape(-1, self.L0, self.sphere_channels)
        E = m0.shape[0]
        zeros = m0.new_zeros(E, self.layout.num_coefficients - self.L0,
                             self.sphere_channels)
        x = torch.cat([m0, zeros], dim=1)[:, self.from_m, :]
        x = rotate_from_edge(wigner, x, self.layout)
        return segment_sum(x, edge_dst, atomic_numbers.shape[0], mask=edge_mask,
                           sorted_ids=True, blocks=blocks, fixed_dst=True,
                           shard=shard) / self.rescale_factor
