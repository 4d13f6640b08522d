"""Mixture-of-Experts FFN gated by the HTR edge context (the MoE variant).

Port of the JAX package's nn/moe.py (reference models/NewFunctions/
GATA_and_all2all_MoE/transformer_block.py:375-634 and the
..._BREAKING_EQUIVARIANCE fork, :569-604, :978-1026):

* ``EquivariantExpertFFN``: linear -> per-degree invariant context gates
  from c_i (SiLU on l=0 only) -> linear;
* ``NonEquivariantExpertFFN``: SiLU on every coefficient (a deliberate
  equivariance violation, ablation only);
* ``MoEHTRFeedForward``: soft softmax routing over the experts from
  c_i = the mean of the HTR-refined t_ij over each node's incoming edges;
  every expert runs on every atom (a dense soft mixture).

The experts are stacked, as the JAX package's ``nn.vmap`` stacks them: each
parameter carries a leading expert axis, in the same order, and all the
experts of a kind run as one batched product (``StackedLinear``).
``MoEHTRFeedForward.routing_entropy`` holds the routing entropy of the last
forward (detached), the value the JAX package ``sow``s under
``intermediates/.../routing_entropy``.

Expert parallelism: the stacked expert axis is declared ``"ep"`` (the JAX
package's ``metadata_params``).  With a ``ModelGroup`` (``mp``) a rank holds
num_experts / M experts of each kind and runs them on every atom; the router
and the mixture weights are replicated, and the weighted sum of the rank's
experts is reduced over ``model``.  ``shard`` (sequence parallelism): t_ij
holds the rank's edges only; the node means of its rows (sum and count
completed over the ranks, ops/segment.py) are gathered.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.segment import segment_mean
from .layers import Linear, StackedLinear

__all__ = ["EquivariantExpertFFN", "NonEquivariantExpertFFN", "MoEHTRFeedForward"]


class EquivariantExpertFFN(nn.Module):
    """``num`` experts: x [N, K, C], c_i [N, edge_C] -> [num, N, K, C]."""

    def __init__(self, num: int, sphere_channels: int, hidden_channels: int,
                 edge_channels: int, lmax: int):
        super().__init__()
        self.lmax, self.H = lmax, hidden_channels
        self.linear_1 = StackedLinear(num, sphere_channels, hidden_channels, bias=False, ep=True)
        self.gate_proj = StackedLinear(num, edge_channels, hidden_channels * (lmax + 1), ep=True)
        self.linear_2 = StackedLinear(num, hidden_channels, sphere_channels, bias=False, ep=True)

    def forward(self, x: torch.Tensor, c_i: torch.Tensor) -> torch.Tensor:
        h = self.linear_1(x, shared=True)                       # [T, N, K, H]
        gates = F.silu(self.gate_proj(c_i, shared=True))        # [T, N, (lmax+1) H]
        out = []
        for l in range(self.lmax + 1):
            hl = h[:, :, l * l : (l + 1) ** 2, :]
            g = gates[:, :, l * self.H : (l + 1) * self.H][:, :, None, :]
            out.append((F.silu(hl) if l == 0 else hl) * g)
        return self.linear_2(torch.cat(out, dim=2))


class NonEquivariantExpertFFN(nn.Module):
    """``num`` deliberately non-equivariant experts (ablation; reference
    :978-1026): x [N, K, C], c_i [N, edge_C] -> [num, N, K, C]."""

    def __init__(self, num: int, sphere_channels: int, hidden_channels: int,
                 edge_channels: int, lmax: int):
        super().__init__()
        self.linear_1 = StackedLinear(num, sphere_channels, hidden_channels, ep=True)
        self.gate_proj = StackedLinear(num, edge_channels, hidden_channels, ep=True)
        self.linear_2 = StackedLinear(num, hidden_channels, sphere_channels, ep=True)

    def forward(self, x: torch.Tensor, c_i: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.linear_1(x, shared=True))   # SiLU on every coefficient
        gate = F.silu(self.gate_proj(c_i, shared=True))
        return self.linear_2(h * gate[:, :, None, :])


class MoEHTRFeedForward(nn.Module):
    def __init__(self, sphere_channels: int, hidden_channels: int, edge_channels: int,
                 lmax: int, num_experts: int = 4, breaking_equivariance: bool = False):
        super().__init__()
        self.router_1 = Linear(edge_channels, edge_channels)
        self.router_2 = Linear(edge_channels, num_experts)
        # breaking: a mixed pool, ceil(K/2) equivariant experts first
        n_equiv = -(-num_experts // 2) if breaking_equivariance else num_experts
        kw = (sphere_channels, hidden_channels, edge_channels, lmax)
        self.experts_eq = EquivariantExpertFFN(n_equiv, *kw)
        self.experts_ne = (NonEquivariantExpertFFN(num_experts - n_equiv, *kw)
                           if num_experts > n_equiv else None)
        self.n_equiv = n_equiv
        self.routing_entropy: torch.Tensor | None = None
        self.mp = None

    def forward(self, x: torch.Tensor, t_ij: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: torch.Tensor, blocks=None, shard=None) -> torch.Tensor:
        """x: [N, K, C]; t_ij: [E, edge_C] -> [N, K, C]; ``blocks``: the batch
        layout (ops/segment.py)."""
        c_i = segment_mean(t_ij, edge_dst, x.shape[0], mask=edge_mask, blocks=blocks,
                           fixed_dst=True, shard=shard)
        if shard is not None:   # the rank's node rows -> every node
            c_i = shard.mp.gather(c_i, dim=0)
        c_i = torch.nan_to_num(c_i, nan=0.0, posinf=1.0, neginf=-1.0)
        w = torch.softmax(self.router_2(F.silu(self.router_1(c_i))), dim=-1)
        self.routing_entropy = (-(w * torch.log(w + 1e-8)).sum(-1)).mean().detach()
        mp = self.mp
        if mp is not None:   # the rank's experts of each kind, on every atom
            x, c_i = mp.copy_to(x), mp.copy_to(c_i)
            n_eq, n_all = self.n_equiv, w.shape[1]
            mine = torch.cat([torch.arange(n_eq)[mp.part(n_eq)],
                              torch.arange(n_eq, n_all)[mp.part(n_all - n_eq)]])
            w = mp.copy_to(w)[:, mine.to(w.device)]
        outs = self.experts_eq(x, c_i)
        if self.experts_ne is not None:
            outs = torch.cat([outs, self.experts_ne(x, c_i)], dim=0)
        if outs.shape[0] != w.shape[1]:
            raise ValueError("expert parallelism needs each expert kind to split over model")
        dt = torch.promote_types(w.dtype, outs.dtype)
        # the soft mixture: out[n] = sum_e w[n, e] expert_e(x)[n]
        out = torch.einsum("ne,enqc->nqc", w.to(dt), outs.to(dt))
        return out if mp is None else mp.reduce_from(out)
