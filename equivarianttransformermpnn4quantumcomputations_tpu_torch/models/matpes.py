"""EquiformerV2 GATA-V2 for MatPES: per-atom energy, autograd forces and
stress.

Port of the JAX package's models/matpes.py (``EquiformerV2MatPES``, with
``gata=True`` the GATA-V2 model, with ``gata=False`` the baseline
EquiformerV2, and with the JAX package's other fields every variant of its
registry (models/registry.py); ``matpes_energy_forces_stress`` and
``matpes_energy_forces_stress_pergraph``).  Batches come in the
fixed-degree layout (``data/graph.py:collate``), whatever layout a
converted checkpoint was trained with: the layout changes no parameter.
Forces are ``-d(sum E)/d pos`` by ``torch.autograd.grad``.  Stress uses the
strain trick with one symmetric strain per graph: positions and cell are
deformed by (I + eps), and stress = sym(dE/d eps) / |det cell| in Voigt-6
order, from the same ``torch.autograd.grad`` call as the forces.  Serving
(``energy_and_forces``) needs only this first derivative and keeps no graph;
force training (``matpes_energy_forces`` with ``create_graph=True``) keeps
it, so the loss backward is a grad-of-grad through every kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..nn.ffn import ESENFeedForward, FeedForward
from ..nn.gata import HTR
from ..nn.global_attn import (
    GlobalFullAttention,
    GlobalFullEquivariantAttention,
    GlobalHTRAttention,
    GlobalScalarAttention,
)
from ..nn.layers import Linear, RadialMLP, StackedLinear
from ..nn.moe import MoEHTRFeedForward
from ..nn.norms import EquivariantDegreeLayerScale, degree_scale_init
from ..nn.remat import remat_call
from ..ops.s2grid import s2grid
from ..ops.segment import segment_sum
from ..utils.trace import span
from .backbone import BACKBONE_OPTIONS, EquiformerV2Backbone

__all__ = ["EquiformerV2MatPES", "energy_and_forces", "matpes_energy_forces",
           "matpes_energy_forces_stress_pergraph", "init_weights", "routing_entropies",
           "FLAGSHIP", "GLOBAL_ATTN"]

# The flagship MatPES GATA-V2 configuration (bench.py:327-335); served with
# cutoff 6.0 and 20 neighbours (bench.py:338-340).
FLAGSHIP = dict(
    num_layers=6, sphere_channels=128, attn_hidden_channels=128, num_heads=8,
    attn_alpha_channels=32, attn_value_channels=16, ffn_hidden_channels=512,
    lmax=4, mmax=2, grid_resolution=18, edge_channels=128, num_rbf=600,
    max_num_elements=100, cutoff=6.0,
)


GLOBAL_ATTN = (None, "scalar", "full", "full_equivariant", "htr", "htr_distance", "htr_rope")


class EquiformerV2MatPES(nn.Module):
    """Backbone + [global attention] + scalar energy head (the JAX
    package's fields and defaults).

    ``alpha_drop``, ``drop_path_rate`` and ``proj_drop`` act only in
    ``train()`` mode; ``compute_dtype`` is the block stack's type
    (models/backbone.py).  ``conv_fused`` sends the full SO(2)-conv sites
    through kernel K3, off by default.  ``gata=False`` builds the baseline
    EquiformerV2 attention instead of GATA-V2; ``wigner_rep`` is the
    backbone's Wigner representation (``"dense"``: kernel K1,
    ``"factored"``: kernel K4, ``"blocks"``: batched matmuls); the batch
    layout is the backbone's ``uniform_blocks`` / ``fixed_degree`` (both
    False: ragged); ``remat`` rematerializes each block in every backward
    (the JAX package's field, whose default there is True; here False, as
    every JAX configuration and bench path sets it); ``options`` are the
    backbone's other fields
    (``models/backbone.py:BACKBONE_OPTIONS``: norms, activations, GATA v1,
    FFN variants, dual stream, atom-edge embeddings).

    ``global_attn`` adds an all-to-all attention stage after the final norm,
    before the energy head (reference equiformerv2_MatPESv2_all2all.py:181
    and the GLOBALALLATTENTION / HTR forks): None, 'scalar', 'full',
    'full_equivariant', 'htr', 'htr_distance' or 'htr_rope'
    (nn/global_attn.py), with ``global_attn_heads`` heads; it runs on the
    flat padded node axis unless ``global_attn_dense_n_max`` (the most atoms
    of a graph) asks for per-graph dense packing.  The stage reads the
    float32 backbone output, as in the JAX package.  The energy head takes
    ``use_gate_act`` / ``use_grid_mlp`` / ``use_sep_s2_act`` like the blocks'
    FFNs.
    """

    def __init__(self, num_layers: int = 6, sphere_channels: int = 128,
                 attn_hidden_channels: int = 128, num_heads: int = 8,
                 attn_alpha_channels: int = 32, attn_value_channels: int = 16,
                 ffn_hidden_channels: int = 512, lmax: int = 4, mmax: int = 2,
                 grid_resolution: int | None = 18, edge_channels: int = 128,
                 num_rbf: int = 600, max_num_elements: int = 100,
                 cutoff: float = 6.0, avg_degree: float = 12.0,
                 alpha_drop: float = 0.05, drop_path_rate: float = 0.05,
                 proj_drop: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 conv_fused: bool = False, gata: bool = True,
                 wigner_rep: str = "dense", global_attn: str | None = None,
                 global_attn_heads: int = 8, global_attn_dense_n_max: int | None = None,
                 remat: bool = False, **options):
        super().__init__()
        if global_attn not in GLOBAL_ATTN:
            raise ValueError(f"global_attn={global_attn!r}: one of {GLOBAL_ATTN}")
        self.global_attn_kind = global_attn
        self.global_attn_dense_n_max = global_attn_dense_n_max
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
            compute_dtype=compute_dtype, gata=gata, conv_fused=conv_fused,
            wigner_rep=wigner_rep, remat=remat, **options,
        )
        if global_attn == "scalar":
            self.global_attn = GlobalScalarAttention(sphere_channels, global_attn_heads)
        elif global_attn == "full":
            self.global_attn = GlobalFullAttention(sphere_channels, (lmax + 1) ** 2,
                                                   global_attn_heads)
        elif global_attn == "full_equivariant":
            self.global_attn = GlobalFullEquivariantAttention(sphere_channels, lmax,
                                                              global_attn_heads)
        elif global_attn is not None:
            self.global_attn = GlobalHTRAttention(
                sphere_channels, lmax, global_attn_heads,
                use_distance=global_attn == "htr_distance",
                use_rope=global_attn == "htr_rope")
        head = {k: options.get(k, BACKBONE_OPTIONS[k])
                for k in ("use_gate_act", "use_grid_mlp", "use_sep_s2_act")}
        self.energy_block = FeedForward(
            sphere_channels, ffn_hidden_channels, 1, lmax,
            s2grid(lmax, lmax, grid_resolution), **head,
        )

    def _global(self, x, batch, pos, generator=None):
        """The global-attention stage on the backbone's output."""
        dense = self.global_attn_dense_n_max
        kw = dict(node_slot=batch["node_slot"] if dense else None, n_max=dense,
                  num_graphs=batch["cell"].shape[0] if dense else None, generator=generator)
        gm, nm = batch["graph_idx"], batch["node_mask"]
        if self.global_attn_kind == "scalar":
            scal = self.global_attn(x[:, 0, :], gm, nm, pos, **kw)
            return torch.cat([scal[:, None, :], x[:, 1:, :]], dim=1)
        return self.global_attn(x, gm, nm, pos, **kw)

    def forward(self, batch: dict, pos: torch.Tensor | None = None,
                generator: torch.Generator | None = None, stack_capture: bool = False,
                stack_override=None):
        """Returns energy [B, 1] (per atom), energy_total [B], node_energy [N].

        ``generator`` draws the dropout masks in ``train()`` mode.  The edge
        vectors take their periodic shifts in ``batch["strained_cell"]``
        when the batch has one (stress), else in ``batch["cell"]``.
        ``stack_capture=True`` returns the backbone's ``(carry, broadcast)``
        before the blocks; ``stack_override=carry`` runs the heads on the
        carry of an external block stack (models/backbone.py; the JAX
        package's hooks of the same names, which parallel/pipeline.py's
        GPipe step uses)."""
        if pos is None:
            pos = batch["pos"]
        x = self.backbone(
            batch["atomic_numbers"], pos, batch["graph_idx"], batch["edge_src"],
            batch["edge_dst"], batch["edge_shift"], batch["edge_mask"],
            batch.get("strained_cell", batch["cell"]), generator,
            stack_capture=stack_capture, stack_override=stack_override,
        )
        if stack_capture:
            return x
        x = x.x
        if self.global_attn_kind is not None:
            x = self._global(x, batch, pos, generator)
        with span("etq.model.head"):
            node_energy = self.energy_block(x)[:, 0, 0]
            num_graphs = batch["cell"].shape[0]
            energy_total = segment_sum(node_energy, batch["graph_idx"], num_graphs,
                                       mask=batch["node_mask"])
            natoms = torch.clamp(batch["natoms"].to(energy_total.dtype), min=1.0)
        return {
            "energy": (energy_total / natoms)[:, None],
            "energy_total": energy_total,
            "node_energy": node_energy,
        }


def routing_entropies(model: nn.Module) -> list[torch.Tensor]:
    """The MoE blocks' routing entropies from the last forward, in block
    order (the values the JAX package sows as ``routing_entropy``)."""
    return [m.routing_entropy for m in model.modules()
            if isinstance(m, MoEHTRFeedForward) and m.routing_entropy is not None]


def _call(model, batch: dict, pos, params, generator):
    if params is None:
        return model(batch, pos=pos, generator=generator)
    return torch.func.functional_call(model, params, (batch,),
                                      dict(pos=pos, generator=generator))


_OUTPUTS = ("energy", "energy_total", "node_energy")


def _energy(model, batch: dict, pos, strain, params, generator, inner_ckpt: bool) -> dict:
    """The model's outputs at ``pos``, deformed by ``strain`` unless it is
    None; with ``inner_ckpt`` the whole evaluation is rematerialized in
    every backward (nn/remat.py; the JAX package's ``jax.checkpoint`` of
    its energy function)."""

    def fn(pos, strain, prm, gen):
        b = batch
        if strain is not None:   # positions and cell deformed by (I + eps) per graph
            cell = batch["cell"]
            defo = torch.eye(3, dtype=cell.dtype, device=cell.device) + strain   # [B, 3, 3]
            pos = torch.einsum("ni,nij->nj", pos, defo[batch["graph_idx"]])
            b = dict(batch, strained_cell=torch.einsum("bij,bjk->bik", cell, defo))
        outs = _call(model, b, pos, prm, gen)
        return tuple(outs[k] for k in _OUTPUTS)

    if not inner_ckpt:
        return dict(zip(_OUTPUTS, fn(pos, strain, params, generator)))
    prm = dict(model.named_parameters()) if params is None else params
    return dict(zip(_OUTPUTS, remat_call(fn, (pos, strain), prm, generator, module=model)))


def matpes_energy_forces(model: EquiformerV2MatPES, batch: dict,
                         create_graph: bool = False, params: dict | None = None,
                         generator: torch.Generator | None = None,
                         regress_stress: bool = False, inner_ckpt: bool = False) -> dict:
    """Energy outputs plus forces F = -dE_total/d pos (masked to real atoms),
    and with ``regress_stress`` the stress of
    ``matpes_energy_forces_stress_pergraph``.

    The counterpart of the JAX package's ``matpes_energy_forces_stress``.
    ``create_graph=True`` keeps the graph of the force pass, so a loss of
    the forces can be differentiated by the parameters (force training).
    ``params``: a name -> tensor mapping to call the model with
    (``torch.func.functional_call``), e.g. the bfloat16 copies of mixed
    precision.  ``inner_ckpt`` rematerializes the whole energy evaluation in
    every backward (the JAX package's argument of the same name): the
    loss's backward then recomputes the force pass.
    """
    if regress_stress:
        return matpes_energy_forces_stress_pergraph(model, batch, create_graph, params,
                                                    generator, inner_ckpt)
    pos = batch["pos"].detach().requires_grad_(True)
    with torch.enable_grad():
        outs = _energy(model, batch, pos, None, params, generator, inner_ckpt)
        with span("etq.model.forces"):
            (dpos,) = torch.autograd.grad(outs["energy_total"].sum(), pos,
                                          create_graph=create_graph)
    result = dict(outs) if create_graph else {k: v.detach() for k, v in outs.items()}
    result["forces"] = -dpos * batch["node_mask"][:, None].to(dpos.dtype)
    return result


def matpes_energy_forces_stress_pergraph(model: EquiformerV2MatPES, batch: dict,
                                         create_graph: bool = False,
                                         params: dict | None = None,
                                         generator: torch.Generator | None = None,
                                         inner_ckpt: bool = False) -> dict:
    """Energy outputs, forces and per-graph stress [B, 6] (Voigt: xx, yy,
    zz, yz, xz, xy; energy units per A^3).

    One strain eps [B, 3, 3] per graph, zero-valued:
    positions become pos @ (I + eps)[graph] and the cell cell @ (I + eps),
    and one ``torch.autograd.grad`` over (pos, eps) gives the forces and
    dE/d eps; stress = sym(dE/d eps) / |det cell|.  Call it inside
    ``utils/precision.full_f32_products`` (the geometry is float32).
    ``inner_ckpt``: as ``matpes_energy_forces``.
    """
    pos = batch["pos"].detach().requires_grad_(True)
    cell = batch["cell"]
    strain = torch.zeros_like(cell, requires_grad=True)
    with torch.enable_grad():
        outs = _energy(model, batch, pos, strain, params, generator, inner_ckpt)
        with span("etq.model.forces"):
            dpos, dstrain = torch.autograd.grad(outs["energy_total"].sum(), (pos, strain),
                                                create_graph=create_graph)
    result = dict(outs) if create_graph else {k: v.detach() for k, v in outs.items()}
    result["forces"] = -dpos * batch["node_mask"][:, None].to(dpos.dtype)
    sym = 0.5 * (dstrain + dstrain.transpose(-1, -2))
    vol = torch.abs(torch.linalg.det(cell))
    s = sym / torch.clamp(vol, min=1e-9)[:, None, None]
    result["stress"] = torch.stack([s[:, 0, 0], s[:, 1, 1], s[:, 2, 2], s[:, 1, 2],
                                    s[:, 0, 2], s[:, 0, 1]], dim=1)
    return result


def energy_and_forces(model: EquiformerV2MatPES, batch: dict) -> dict:
    """Serving: energy outputs and forces, no graph kept."""
    return matpes_energy_forces(model, batch, create_graph=False)


# Flax's truncated-normal variance scaling divides the std by the std of a
# unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, each leaf drawn from the
    distribution that the JAX package's initializer gives it:

    * dense, SO3 and SO2 matrices ~ normal(0, 1/fan_in) (``fan_in_normal``,
      the reference's effective init), biases 0;
    * radial-MLP linears ~ uniform(+-1/sqrt(fan_in)) (``fan_in_uniform``);
    * HTR's ``gamma_w`` ~ Xavier uniform;
    * ``sphere_embedding``: Flax ``nn.Embed``'s default, a truncated normal
      (+-2 std) of variance 1/features; the atom-edge embeddings ~
      uniform(+-0.001);
    * ``alpha_dot`` ~ uniform(+-1/sqrt(A)); ``rope_freqs`` ~ 0.1 normal;
    * the eSEN gate projections: weight 0, bias 2.0;
    * norm scales 1 and biases 0 (the per-degree layer scale 1 and
      1/sqrt(2 l)).

    Stacked parameters (the QM9 heads, the MoE experts: a leading head or
    expert axis) take the rule of one slice for each slice.
    """
    parent = {c: (m, n) for m in model.modules() for n, c in m.named_children()}
    for mod in model.modules():
        owner, name = parent.get(mod, (None, ""))
        while isinstance(owner, nn.ModuleList):   # the module that holds the list
            owner, name = parent.get(owner, (None, ""))
        for leaf, p in mod.named_parameters(recurse=False):
            _init_leaf(p, mod, leaf, owner, name, generator)
    return model


def _init_leaf(p: torch.Tensor, mod: nn.Module, leaf: str, owner: nn.Module | None,
               name: str, generator: torch.Generator) -> None:
    esen_gate = isinstance(owner, ESENFeedForward) and name.startswith("gate_proj")
    if isinstance(mod, EquivariantDegreeLayerScale):
        p.copy_(degree_scale_init(mod.lmax, p.shape[1], mod.scale_factor))
    elif leaf == "bias" or leaf.startswith("b_m"):
        p.fill_(2.0 if esen_gate else 0.0)
    elif isinstance(mod, nn.LayerNorm) or "Norm" in type(mod).__name__:
        p.fill_(1.0)
    elif isinstance(mod, nn.Embedding):
        if name == "sphere_embedding":
            std = p.shape[1] ** -0.5 / _TRUNC_STD
            nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std, generator=generator)
        else:
            p.uniform_(-1e-3, 1e-3, generator=generator)
    elif leaf == "alpha_dot":
        b = 1.0 / math.sqrt(p.shape[1])
        p.uniform_(-b, b, generator=generator)
    elif leaf == "rope_freqs":
        p.normal_(0.0, 0.1, generator=generator)
    elif esen_gate:
        p.zero_()
    elif isinstance(owner, RadialMLP):
        b = 1.0 / math.sqrt(p.shape[-1])
        p.uniform_(-b, b, generator=generator)
    elif isinstance(owner, HTR) and name == "gamma_w":
        b = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
        p.uniform_(-b, b, generator=generator)
    else:
        # Linear [out, in] and StackedLinear [T, out, in]: fan-in is the
        # last axis; SO3Linear [L, in, out], its stacked form and the SO2
        # conv's w_m* [in, out]: the second to last
        fan_in = p.shape[-1] if isinstance(mod, (Linear, StackedLinear)) else p.shape[-2]
        p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
