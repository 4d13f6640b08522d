"""GATA components: HTR edge-stream refinement and the GATA value activation.

Port of the JAX package's nn/gata.py (``HTR``, ``GATAValueActivation``,
``gata_value_activation_v1``).
``t_ij`` is a per-edge invariant stream threaded through all blocks; HTR
refines it each layer from inner products of the steerable node features
with the edge-direction component rejected; the value activation turns it
into per-degree gates applied to the edge-direction SH and the neighbour's
steerable features.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.gata_value import gata_value
from .layers import Linear
from .partition import chunked_index

__all__ = ["HTR", "GATAValueActivation", "gata_value_activation_v1"]


def gata_value_activation_v1(gates: torch.Tensor, X_j: torch.Tensor, rl_ij: torch.Tensor,
                             lmax: int, hidden_channels: int) -> torch.Tensor:
    """GATA v1 value activation, parameter-free (reference
    Gotennet_inspired/activation.py:168-245): no t_ij stream, the gates
    o_s / o_d^(l) / o_t^(l) come straight from so2_conv_1's extra m = 0
    outputs, X_j is used unprojected and the output keeps the full
    (lmax+1)^2 width (so the model runs with mmax == lmax).

    gates: [E, (1 + 2 lmax) C]; X_j: [E, K_full-1, C] unrotated;
    rl_ij: [E, K_full-1].  Returns [E, K_full, C].
    """
    C = hidden_channels
    rl_ij = rl_ij.to(gates.dtype)
    out = [F.silu(gates[:, :C])[:, None, :]]
    offset = 0
    for l in range(1, lmax + 1):
        d = 2 * l + 1
        rl = rl_ij[:, offset : offset + d, None]
        Xl = X_j[:, offset : offset + d, :]
        offset += d
        od = gates[:, l * C : (l + 1) * C][:, None, :]
        ot = gates[:, (lmax + l) * C : (lmax + l + 1) * C][:, None, :]
        out.append(od * rl + ot * Xl)
    return torch.cat(out, dim=1)


class HTR(nn.Module):
    """Hierarchical Tensor Refinement of the invariant edge stream t_ij.

        w_ij  = sum_l < rej(W_vq X_i^(l), r), rej(W_vk^(l) X_j^(l), r) > / (2l+1)
        t_ij += gamma_w(w_ij) * gamma_t(t_ij)

    rej(v, r) = (I - r r^T) v is symmetric with P^2 = I - (2 - s) r r^T,
    s = |r|^2, so the inner product is <qi, kj> - (2 - s) <qi, r> <kj, r>
    (the JAX package's algebraic form; no rejected tensors are built).
    """

    def __init__(self, sphere_channels: int, edge_channels: int, lmax: int,
                 hidden_channels: int | None = None):
        super().__init__()
        hidden = hidden_channels or edge_channels
        self.lmax = lmax
        self.W_vq = Linear(sphere_channels, hidden, bias=False)
        for l in range(1, lmax + 1):
            setattr(self, f"W_vk_{l}", Linear(sphere_channels, hidden, bias=False))
        self.gamma_w = Linear(hidden, edge_channels)
        self.gamma_t_1 = Linear(edge_channels, edge_channels)
        self.gamma_t_2 = Linear(edge_channels, edge_channels)

    def forward(self, t_ij, X_i, X_j, rl_ij):
        """t_ij [E, edge_C]; X_i / X_j [E, K-1, sphere_C]; rl_ij [E, K-1]."""
        rl_ij = rl_ij.to(X_i.dtype)
        q = self.W_vq(X_i)
        w_ij = t_ij.new_zeros(t_ij.shape[0], q.shape[2])
        offset = 0
        for l in range(1, self.lmax + 1):
            d = 2 * l + 1
            sl = slice(offset, offset + d)
            offset += d
            rl = rl_ij[:, sl, None]
            qi = q[:, sl, :]
            kj = getattr(self, f"W_vk_{l}")(X_j[:, sl, :])
            qk = (qi * kj).sum(1)
            qr = (qi * rl).sum(1)
            kr = (kj * rl).sum(1)
            s = (rl * rl).sum(1)
            w_ij = w_ij + (qk - (2.0 - s) * qr * kr) / d
        gw = F.silu(self.gamma_w(w_ij))
        gt = F.silu(self.gamma_t_2(F.silu(self.gamma_t_1(t_ij))))
        return t_ij + gw * gt


class GATAValueActivation(nn.Module):
    """GATA gating in place of the separable-S2 value activation.

    Inputs: attn_output [E, S*C] (S = 1 + 2 lmax, the extra m=0 outputs of
    so2_conv_1), t_ij [E, edge_C], h_j [E, sphere_C], X_j [E, K-1, sphere_C]
    (unrotated), rl_ij [E, K-1].  Output [E, K_red, C] in the reduced layout,
    written from unrotated-frame quantities, and for each degree l the first
    min(2l+1, 2 mmax+1) rows — the reference's mmax-clip quirk, kept
    (activation.py:388-409).  ``use_phi`` (the phi-every-layer variant)
    multiplies the bias by ``phi_proj(phi_r)``, phi_r [E, num_rbf] the
    distance RBF.

    Tensor-parallel roles (the JAX package's): ``W_rs``, ``gamma_s`` and
    ``xj_proj`` split the hidden channels (column; the gates as S chunks of
    C).  With a ``ModelGroup`` (``mp``) the activation runs on the rank's
    C/M channels of every chunk: ``attn_output`` holds those channels, and
    the replicated ``phi_proj`` contributes its columns of them;
    ``copied``: ``h_j`` and ``X_j`` already went through ``copy_to``.
    """

    def __init__(self, sphere_channels: int, hidden_channels: int,
                 edge_channels: int, lmax: int, mmax: int, use_phi: bool = False,
                 num_rbf: int = 0):
        super().__init__()
        S = 1 + 2 * lmax
        self.C, self.lmax, self.mmax = hidden_channels, lmax, mmax
        gates = [hidden_channels] * S
        self.W_rs = Linear(edge_channels, S * hidden_channels, tp="col", out_chunks=gates)
        self.gamma_s = Linear(sphere_channels, S * hidden_channels, tp="col", out_chunks=gates)
        self.xj_proj = Linear(sphere_channels, hidden_channels, bias=False, tp="col")
        self.use_phi = use_phi
        if use_phi:
            self.phi_proj = Linear(num_rbf, S * hidden_channels)
        self.mp = None

    def _phi(self, phi_r):
        """``phi_proj(phi_r)``: on the rank's gate channels under TP."""
        if self.mp is None:
            return self.phi_proj(phi_r)
        mp, S = self.mp, 1 + 2 * self.lmax
        idx = torch.as_tensor(chunked_index(S * self.C, [self.C] * S, mp.rank, mp.size),
                              device=phi_r.device)
        w, b = mp.copy_to(self.phi_proj.weight), mp.copy_to(self.phi_proj.bias)
        x = mp.copy_to(phi_r)
        dt = torch.promote_types(x.dtype, w.dtype)
        return F.linear(x.to(dt), w[idx].to(dt), b[idx].to(dt))

    def forward(self, attn_output, t_ij, h_j, X_j, rl_ij, phi_r=None, copied: bool = False):
        r = self.W_rs(t_ij)
        g = self.gamma_s(h_j, copied=copied)
        p = self._phi(phi_r) if self.use_phi else None
        Xp = self.xj_proj(X_j, copied=copied)
        # one dtype for the kernels: the composite step's f32 masters in a
        # bf16 model make the linears' outputs f32 beside bf16 rl_ij
        dt = attn_output.dtype
        for t in (r, g, p, Xp):
            if t is not None:
                dt = torch.promote_types(dt, t.dtype)
        cast = lambda t: t.to(dt) if t is not None else None  # noqa: E731
        # the elementwise body: kernels K5a-c on the card (ops/cuda/gata_value.py)
        return gata_value(cast(attn_output), cast(r), cast(g), cast(p), cast(Xp),
                          cast(rl_ij), self.lmax, self.mmax)
