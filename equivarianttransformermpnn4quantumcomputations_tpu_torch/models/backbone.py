"""EquiformerV2 backbone (port of the JAX package's models/backbone.py).

atom embedding -> distance RBF -> edge-degree embedding -> [GATA edge
stream] -> N transformer blocks -> final norm.  Displacement vectors are re-derived
from positions inside the forward, so forces flow by autograd; the per-edge
Wigner rotation is built once per forward and shared by every rotate, in
one of three representations chosen at construction (``wigner_rep``, the
JAX package's model field): ``"dense"`` (the default; the pairs form of
kernel K1), ``"factored"`` (the cos / sin tables of kernel K4) or
``"blocks"`` (one [E, 2l+1, 2l+1] block per degree, applied by batched
matmuls, as the JAX package applies it outside any Pallas kernel).  All
three give the same numbers.

Every configuration of the JAX package's backbone fields is ported:
``gata=True`` (GATA-V2: ``h_proj`` / ``W_erp`` build the edge stream
``t_ij``, and the global-frame edge SH ``rl_ij`` go to every block),
``gata_v1`` (GATA v1: ``rl_ij`` only, no ``t_ij``) or neither (the baseline
EquiformerV2); ``dual_stream`` (a second, angular edge stream ``a_ij``
from ``a_h_proj`` / ``a_W_erp``); ``norm_type``; the attention and FFN
options (``use_gate_act``, ``use_grid_mlp``, ``use_sep_s2_act``,
``use_m_share_rad``, ``use_attn_renorm``, ``normalize_attn_output``,
``use_phi_every_layer``, ``ffn_variant``, ``num_experts``); and the
atom-edge embeddings, per block (``use_atom_edge_embedding``) or shared
by all blocks and the edge-degree embedding
(``share_atom_edge_embedding``: concatenated to the edge scalars once).
``conv_fused`` sends the full SO(2)-conv sites through kernel K3 (the JAX
package's ``KernelFlags.conv_fused``; off by default there and here).
``remat`` rematerializes each block in every backward (nn/remat.py, the
JAX package's ``nn.remat``): a block keeps only its inputs and
parameters, so force training holds one block's second-order graph at a
time.
The edge layout is the JAX package's pair of model fields:
``uniform_blocks`` and ``fixed_degree``, both False by default (the ragged
layout of ``data/graph.py:collate``); ``fixed_degree`` (k = E / N edge slots
per node) implies uniform blocks.  The forward turns them into the
``blocks`` tuple that every segment op reads (ops/segment.py).  ``cell`` may
be a strained cell (``models/matpes.py``'s stress): the periodic shifts
are taken in it, so the edge vectors see the strain.

``compute_dtype=torch.bfloat16`` follows the JAX package's casts: the node
features, the edge scalars, ``t_ij`` and ``rl_ij`` enter the block stack in
bfloat16, the geometry (displacements, Wigner values, RBF) and the
edge-degree embedding stay float32, norms compute in float32, and the
final norm's output is float32.

The forward is three parts: the pre-stack (geometry, Wigner tables,
embeddings, the GATA streams, the cast to the compute type), the blocks
(``run_blocks``, one ``block_step`` each, on the carry ``(x, t_ij, a_ij)``
and the ``StackBroadcast``) and the post-stack (``post_stack``, the final
norm); the JAX package's ``stack_capture`` / ``stack_override`` hooks stop
after the first and start at the last, for parallel/pipeline.py's GPipe
schedule.

Sequence parallelism (a ``ModelGroup`` with ``sp``, parallel/sharding.py;
any edge layout): the backbone takes this rank's even, contiguous slice of
the whole edge arrays it is given (``ModelGroup.edge_shard``: edges
[r E/M, (r+1) E/M), node rows [r N/M, (r+1) N/M));
positions and cell enter the edge region through ``copy_to``, so the forces
and the strain derivative sum the ranks' shares; the displacements, Wigner
tables, distance RBF, edge-degree embedding, ``t_ij`` and ``rl_ij`` cover
the rank's edges only; the edge-degree embedding's sums onto the targets
are completed onto the rank's node rows (ops/segment.py), which are
gathered.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn

from ..nn.block import TransBlock
from ..nn.embedding import EdgeDegreeEmbedding
from ..nn.layers import GaussianSmearing, Linear
from ..nn.norms import get_normalization_layer
from ..nn.remat import remat_call
from ..ops.cuda.rotate_dense import WignerDense, compute_wigner_dense
from ..ops.irreps import layout as get_layout
from ..ops.rotation import WignerBlocks, WignerFactors, compute_wigner, compute_wigner_blocks
from ..ops.s2grid import s2grid
from ..ops.segment import gather_nodes
from ..ops.sph import real_sph_harm
from ..utils.trace import span

__all__ = ["EquiformerV2Backbone", "BackboneOutput", "StackBroadcast", "block_step", "WIGNER_REPS",
           "BACKBONE_OPTIONS"]

WIGNER_REPS = ("dense", "factored", "blocks")
# the backbone's options beyond the widths, with the JAX package's defaults
# (models/backbone.py:126-149); the models pass them through by name
BACKBONE_OPTIONS = dict(
    norm_type="rms_norm_sh", use_atom_edge_embedding=True,
    share_atom_edge_embedding=False, use_m_share_rad=False, use_attn_renorm=True,
    use_gate_act=False, use_grid_mlp=False, use_sep_s2_act=True, gata_v1=False,
    normalize_attn_output=True, use_phi_every_layer=False, ffn_variant="standard",
    num_experts=4, dual_stream=False,
)


@dataclass
class BackboneOutput:
    """What the heads read (the JAX package's ``BackboneOutput``): node
    features after the final norm [N, (lmax+1)^2, C] (float32), the edge
    scalars (distance RBF, with the shared atom-edge embeddings when
    ``share_atom_edge_embedding``; float32), the forward's Wigner rotation
    and the layout's ``blocks`` tuple (None: ragged)."""

    x: torch.Tensor
    edge_scalars: torch.Tensor
    wigner: Union[WignerDense, WignerFactors, WignerBlocks]
    blocks: Optional[tuple]


class EquiformerV2Backbone(nn.Module):
    def __init__(self, num_layers: int, sphere_channels: int,
                 attn_hidden_channels: int, num_heads: int,
                 attn_alpha_channels: int, attn_value_channels: int,
                 ffn_hidden_channels: int, lmax: int, mmax: int,
                 grid_resolution: Optional[int], edge_channels: int,
                 num_rbf: int, max_num_elements: int, cutoff: float,
                 avg_degree: float, alpha_drop: float = 0.0,
                 drop_path_rate: float = 0.0, proj_drop: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32, gata: bool = True,
                 conv_fused: bool = False, wigner_rep: str = "dense",
                 uniform_blocks: bool = False, fixed_degree: bool = False,
                 remat: bool = False, **options):
        super().__init__()
        if wigner_rep not in WIGNER_REPS:
            raise ValueError(f"wigner_rep={wigner_rep!r}: one of {WIGNER_REPS}")
        unknown = set(options) - set(BACKBONE_OPTIONS)
        if unknown:
            raise TypeError(f"unknown backbone options {sorted(unknown)}")
        opt = {**BACKBONE_OPTIONS, **options}
        self.wigner_rep = wigner_rep
        self.uniform_blocks, self.fixed_degree = uniform_blocks, fixed_degree
        self.remat = remat
        self.lmax, self.mmax = lmax, mmax
        self.gata, self.gata_v1 = gata, opt["gata_v1"]
        self.dual_stream = gata and opt["dual_stream"]
        self.use_phi_every_layer = opt["use_phi_every_layer"]
        self.compute_dtype = compute_dtype
        self.sphere_channels = sphere_channels
        lay_full, lay_red = get_layout(lmax, lmax), get_layout(lmax, mmax)
        self.K_full = lay_full.num_coefficients_full
        edge_channels_list = [num_rbf, edge_channels, edge_channels]
        self.smear = GaussianSmearing(0.0, cutoff, num_rbf, 2.0)
        self.share = opt["share_atom_edge_embedding"] and opt["use_atom_edge_embedding"]
        if self.share:
            self.shared_source_embedding = nn.Embedding(max_num_elements, edge_channels)
            self.shared_target_embedding = nn.Embedding(max_num_elements, edge_channels)
            edge_channels_list[0] += 2 * edge_channels
        block_atom_edge = opt["use_atom_edge_embedding"] and not self.share
        self.sphere_embedding = nn.Embedding(max_num_elements, sphere_channels)
        self.edge_degree_embedding = EdgeDegreeEmbedding(
            sphere_channels, lay_red, max_num_elements, edge_channels_list,
            avg_degree, use_atom_edge_embedding=block_atom_edge,
        )
        if gata:
            self.h_proj = Linear(sphere_channels, edge_channels)
            self.W_erp = Linear(num_rbf, edge_channels)
            if self.dual_stream:
                self.a_h_proj = Linear(sphere_channels, edge_channels)
                self.a_W_erp = Linear(num_rbf, edge_channels)
        grid_red = s2grid(lmax, mmax, grid_resolution)
        grid_full = s2grid(lmax, lmax, grid_resolution)
        block_opts = {k: opt[k] for k in (
            "norm_type", "use_m_share_rad", "use_attn_renorm", "use_gate_act", "use_grid_mlp",
            "use_sep_s2_act", "gata_v1", "ffn_variant", "num_experts", "dual_stream")}
        self.blocks = nn.ModuleList(
            TransBlock(lay_full, lay_red, grid_red, grid_full, sphere_channels,
                       attn_hidden_channels, num_heads, attn_alpha_channels,
                       attn_value_channels, ffn_hidden_channels,
                       max_num_elements, edge_channels_list, edge_channels,
                       alpha_drop, drop_path_rate, proj_drop, gata, conv_fused,
                       opt["normalize_attn_output"], opt["use_phi_every_layer"],
                       use_atom_edge_embedding=block_atom_edge, num_rbf=num_rbf,
                       **block_opts)
            for _ in range(num_layers)
        )
        self.norm = get_normalization_layer(opt["norm_type"], lmax, sphere_channels)
        self.mp = None

    def forward(self, atomic_numbers, pos, graph_idx, edge_src, edge_dst,
                edge_shift, edge_mask, cell,
                generator: Optional[torch.Generator] = None, stack_capture: bool = False,
                stack_override=None):
        """The heads' inputs (``BackboneOutput``); ``generator`` draws the
        dropout masks in ``train()``.

        The forward is three parts, which an external executor (the GPipe
        schedule of parallel/pipeline.py) may run apart, as in the JAX
        package: ``stack_capture=True`` stops before the blocks and returns
        ``(carry, broadcast)`` (``pre_stack``); ``stack_override=carry``
        skips the geometry and the blocks and returns the final norm of the
        carry's node features (``post_stack``; ``BackboneOutput`` without
        ``edge_scalars`` and ``wigner``)."""
        N, E = atomic_numbers.shape[0], edge_src.shape[0]
        blocks = self.layout_blocks(N, E, cell.shape[0])
        if stack_override is not None:
            return BackboneOutput(self.post_stack(stack_override[0]), None, None, blocks)
        carry, broadcast, edge_scalars = self._pre_stack(
            atomic_numbers, pos, graph_idx, edge_src, edge_dst, edge_shift, edge_mask, cell)
        if stack_capture:
            return carry, broadcast
        shard = self._shard(N, E)
        carry = self.run_blocks(carry, broadcast, cell.shape[0], generator=generator,
                                shard=shard)
        return BackboneOutput(self.post_stack(carry[0]), edge_scalars, broadcast.wigner, blocks)

    def layout_blocks(self, N: int, E: int, num_graphs: int) -> Optional[tuple]:
        """The layout's ``blocks`` tuple (the JAX backbone's): None for the
        ragged layout, ``(B, n_max, e_max)`` for uniform blocks, and
        ``(B, n_max, e_max, k)`` for the fixed-degree layout."""
        if not (self.uniform_blocks or self.fixed_degree):
            return None
        if N % num_graphs or E % num_graphs:
            raise ValueError("uniform_blocks requires n_pad/e_pad divisible by the number of "
                             "graphs (use collate(uniform=True))")
        blocks = (num_graphs, N // num_graphs, E // num_graphs)
        if self.fixed_degree:
            if E % N:
                raise ValueError("fixed_degree requires e_pad divisible by n_pad "
                                 "(use collate(fixed_degree=True))")
            blocks = blocks + (E // N,)
        return blocks

    def _shard(self, N: int, E: int):
        """This rank's ``EdgeShard`` under sequence parallelism (None without,
        or where the edge axis stays whole)."""
        mp = self.mp
        if mp is None:
            return None
        return mp.edge_shard(N, E, fixed=self.fixed_degree)

    def _pre_stack(self, atomic_numbers, pos, graph_idx, edge_src, edge_dst, edge_shift,
                   edge_mask, cell):
        """Geometry, Wigner tables, embeddings and the GATA streams, cast to
        the compute type: ``(carry, broadcast, edge_scalars)``, carry =
        ``(x, t_ij, a_ij)`` (the JAX package's ``stack_capture`` protocol),
        ``edge_scalars`` in float32 for the heads."""
        N, E = atomic_numbers.shape[0], edge_src.shape[0]
        blocks = self.layout_blocks(N, E, cell.shape[0])
        mp = self.mp
        shard = self._shard(N, E)

        def edge(module, *args, **kw):   # a module on this rank's edges
            return module(*args, **kw) if shard is None else mp.call_divergent(module, *args,
                                                                               **kw)

        pos_e = pos
        if shard is not None:   # this rank's edges; positions enter the edge region
            edge_src, edge_dst, edge_shift, edge_mask = (
                t[shard.edges] for t in (edge_src, edge_dst, edge_shift, edge_mask))
            pos_e, cell = mp.copy_to(pos), mp.copy_to(cell)

        # displacements (carry the gradient to pos)
        shift_cart = torch.einsum(
            "ek,ekj->ej", edge_shift.to(pos.dtype), cell[graph_idx[edge_dst]]
        )
        dvec = (gather_nodes(pos_e, edge_dst, blocks, canonical_dst=True, shard=shard)
                + shift_cart - gather_nodes(pos_e, edge_src, blocks))
        dist = torch.sqrt(torch.clamp((dvec * dvec).sum(-1), min=1e-12))

        with span("etq.model.wigner"):
            if self.wigner_rep == "factored":
                wigner = compute_wigner(self.lmax, dvec)
            elif self.wigner_rep == "blocks":
                wigner = compute_wigner_blocks(self.lmax, dvec)
            else:
                wigner = compute_wigner_dense(self.lmax, self.mmax, dvec)
        with span("etq.model.embedding"):
            phi_r = self.smear(dist)
            edge_scalars = phi_r
            if self.share:
                edge_scalars = torch.cat([phi_r,
                                          edge(self.shared_source_embedding,
                                               atomic_numbers[edge_src]),
                                          edge(self.shared_target_embedding,
                                               atomic_numbers[edge_dst])],
                                         dim=1)

            x = pos.new_zeros(N, self.K_full, self.sphere_channels)
            x = torch.cat([self.sphere_embedding(atomic_numbers)[:, None, :],
                           x[:, 1:, :]], dim=1)
            deg = edge(self.edge_degree_embedding, atomic_numbers, edge_scalars, edge_src,
                       edge_dst, edge_mask, wigner, blocks, shard=shard)
            x = x + (deg if shard is None else mp.gather(deg, dim=0))

            cdt = self.compute_dtype
            t_ij = rl_ij = a_ij = None
            if self.gata or self.gata_v1:
                # global-frame edge SH (l >= 1, 'norm', detached)
                unit = dvec / dist[:, None]
                rl_ij = real_sph_harm(self.lmax, unit, normalization="norm")[:, 1:].detach()
                rl_ij = rl_ij.to(cdt)
            if self.gata:
                # t_ij = h_proj(h_i + h_j) * W_erp(phi(r)); the angular stream
                # a_ij the same way with its own projections
                h = x[:, 0, :]
                if shard is not None:
                    h = mp.copy_to(h)
                h_sum = (gather_nodes(h, edge_src, blocks)
                         + gather_nodes(h, edge_dst, blocks, canonical_dst=True, shard=shard))
                t_ij = (edge(self.h_proj, h_sum) * edge(self.W_erp, phi_r)).to(cdt)
                if self.dual_stream:
                    a_ij = (edge(self.a_h_proj, h_sum) * edge(self.a_W_erp, phi_r)).to(cdt)
        x, edge_scalars_c = x.to(cdt), edge_scalars.to(cdt)
        phi_c = phi_r.to(cdt) if self.use_phi_every_layer else None
        broadcast = StackBroadcast(atomic_numbers, edge_scalars_c, edge_src, edge_dst,
                                   edge_mask, wigner, graph_idx, rl_ij, phi_c, blocks)
        return (x, t_ij, a_ij), broadcast, edge_scalars

    def run_blocks(self, carry: tuple, broadcast: "StackBroadcast", num_graphs: int,
                   lo: int = 0, hi: Optional[int] = None,
                   generator: Optional[torch.Generator] = None, shard=None,
                   params: Optional[dict] = None):
        """Blocks ``[lo, hi)`` on ``carry``; returns the carry after them.
        ``params``: a name -> tensor mapping (the backbone's names) to call
        the blocks with; ``shard``: sequence parallelism's ``EdgeShard``."""
        for i in range(lo, len(self.blocks) if hi is None else hi):
            prefix = f"blocks.{i}."
            sub = None if params is None else {n[len(prefix):]: v for n, v in params.items()
                                               if n.startswith(prefix)}
            carry = block_step(self.blocks[i], carry, broadcast, num_graphs, generator, shard,
                               sub, self.remat)
        return carry

    def post_stack(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm of the block stack's node features (float32)."""
        return self.norm(x).float()


class StackBroadcast(NamedTuple):
    """What every block reads besides the carry (the JAX package's
    ``broadcast`` tuple, in its order): ``edge_scalars`` and ``rl_ij`` /
    ``phi_r`` in the compute type, None where the configuration has none;
    then the layout's ``blocks`` tuple (None: ragged)."""

    atomic_numbers: torch.Tensor
    edge_scalars: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    wigner: Union[WignerDense, WignerFactors, WignerBlocks]
    graph_idx: torch.Tensor
    rl_ij: Optional[torch.Tensor]
    phi_r: Optional[torch.Tensor]
    blocks: Optional[tuple]


def block_step(block: nn.Module, carry: tuple, broadcast: StackBroadcast, num_graphs: int,
               generator: Optional[torch.Generator] = None, shard=None,
               params: Optional[dict] = None, remat: bool = False) -> tuple:
    """One block on ``carry`` = (x, t_ij, a_ij); ``params``: a name ->
    tensor mapping to call the block with (``torch.func.functional_call``);
    ``remat``: rematerialized in each backward (nn/remat.py), keeping only
    the carry, the broadcast and the parameters."""

    def call(x, t_ij, a_ij, b, prm, gen):
        args = (x, b.atomic_numbers, b.edge_scalars, b.edge_src, b.edge_dst, b.edge_mask,
                b.wigner, t_ij, b.rl_ij, b.blocks, b.graph_idx, num_graphs, gen, b.phi_r, a_ij)
        if prm is None:
            return block(*args, shard=shard)
        return torch.func.functional_call(block, prm, args, {"shard": shard})

    if not remat:
        return call(*carry, broadcast, params, generator)
    # every parameter of the block passes through the recompute's inputs
    prm = {**dict(block.named_parameters()), **(params or {})}
    return remat_call(call, (*carry, broadcast), prm, generator, module=block)
