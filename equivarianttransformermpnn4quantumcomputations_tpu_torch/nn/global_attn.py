"""Global all-to-all attention family (the "all2all" variant library).

Port of the JAX package's nn/global_attn.py (reference models/NewFunctions/
GATA_and_all2all/activation.py):

* ``GlobalScalarAttention``: MHSA on the invariant l = 0 channel only,
  optional Euclidean-RoPE distance bias (reference :419-575);
* ``GlobalFullAttention``: MHSA over the flattened (coeff x channel)
  vector; it breaks equivariance on purpose (ablation; reference :581-683);
* ``GlobalFullEquivariantAttention``: per-degree attention, Q / K from
  invariant degree norms, equivariant values (reference :686-915);
* ``GlobalHTRAttention``: pairwise invariant scores
  s_ij = sum_l <X_i^(l), Y_l(r_ij_hat)> / (2l+1), optional fixed-centre RBF
  distance term, optional RoPE logit bias (reference :1025-1567).

These are plain tensor ops in the JAX package (einsum, softmax, segment
code; no Pallas kernel), and plain tensor ops here, with the JAX package's
semantics: ``_masked_softmax`` turns all-masked rows into exact zeros
(logits set to ``_NEG = -1e30``), positions are detached exactly where the
JAX package stops their gradient, and the HTR query / key are masked means
over the valid pairs.  No library attention kernel takes their place (its
all-masked rows give NaN).

Each class takes the JAX class's attention-weight ``dropout`` (default 0,
which no model changes): in ``train()`` mode each weight is kept with
probability 1 - dropout and scaled by 1 / (1 - dropout), its mask drawn
from the forward's ``generator``, as ``nn.Dropout`` does it in the JAX
package; in ``eval()`` mode, or at 0, nothing is drawn.

One batched attention core serves two layouts (``_Packing``).  With
``(node_slot, n_max, num_graphs)`` given, nodes are packed per graph into
[B, n_max, ...] and attention costs O(B n_max^2); without them the flat
padded node axis is one B = 1 batch with a same-graph pair mask,
O(N_pad^2).  Both take the same parameters and agree up to the order of
the sums.

Faithfulness note (kept from the JAX package): the reference finishes each
degree with a standard LayerNorm over channels per coefficient (:875-877),
whose centering and bias are not strictly equivariant for l > 0.
"""

from __future__ import annotations

import math
import torch
import torch.nn as nn

from ..ops.sph import real_sph_harm
from .layers import LayerNorm, Linear, keep_mask

__all__ = ["GlobalScalarAttention", "GlobalFullAttention", "GlobalFullEquivariantAttention",
           "GlobalHTRAttention", "to_dense", "from_dense", "dense_mask"]

_NEG = -1e30


def _pair_mask(graph_idx, node_mask, exclude_self: bool = False):
    """[N, N] bool: the valid attention pairs (same graph, both real)."""
    m = (graph_idx[:, None] == graph_idx[None, :]) & node_mask[:, None] & node_mask[None, :]
    if exclude_self:
        m = m & ~torch.eye(graph_idx.shape[0], dtype=torch.bool, device=m.device)
    return m


def _dense_index(graph_idx, node_slot, n_max: int):
    """Row of each node in a [B (n_max + 1)] buffer; the padding nodes'
    out-of-range slot sentinel lands in each graph's spare last row."""
    return graph_idx.long() * (n_max + 1) + torch.clamp(node_slot.long(), max=n_max)


def to_dense(x, graph_idx, node_slot, num_graphs: int, n_max: int):
    """Pack flat node features [N, ...] into per-graph dense [B, n_max, ...]
    (the padding nodes are dropped)."""
    rest = tuple(x.shape[1:])
    buf = x.new_zeros((num_graphs * (n_max + 1),) + rest)
    buf = buf.index_copy(0, _dense_index(graph_idx, node_slot, n_max), x)
    return buf.reshape((num_graphs, n_max + 1) + rest)[:, :n_max]


def from_dense(dense, graph_idx, node_slot):
    """Gather per-graph dense features back to the flat node axis."""
    B, n = dense.shape[:2]
    slot = torch.clamp(node_slot.long(), max=n - 1)
    return dense.reshape((B * n,) + tuple(dense.shape[2:]))[graph_idx.long() * n + slot]


def dense_mask(node_mask, graph_idx, node_slot, num_graphs: int, n_max: int):
    return to_dense(node_mask.float(), graph_idx, node_slot, num_graphs, n_max) > 0.5


def _masked_softmax(logits, mask):
    """Softmax over the last axis with False -> 0 and all-masked rows -> 0."""
    w = torch.softmax(torch.where(mask, logits, torch.full_like(logits, _NEG)), dim=-1)
    return torch.where(mask, w, torch.zeros_like(w))


def _attn_dropout(attn, rate: float, training: bool, generator):
    """The JAX classes' ``nn.Dropout(rate)`` on the attention weights."""
    if rate == 0.0 or not training:
        return attn
    keep = 1.0 - rate
    return attn * keep_mask(attn.shape, keep, generator, attn.device).to(attn.dtype) / keep


class _Packing:
    """Uniform [B, n, ...] view of the node axis: per-graph packing (dense
    mode; the pair mask is row validity only) or the B = 1 view of the
    padded axis (flat mode; the pair mask also holds the same-graph
    constraint)."""

    def __init__(self, graph_idx, node_mask, node_slot, n_max, num_graphs):
        self.graph_idx, self.node_mask, self.node_slot = graph_idx, node_mask, node_slot
        self.dense = node_slot is not None and n_max is not None and bool(num_graphs)
        if self.dense:
            self.B, self.n = num_graphs, n_max
            self.valid = dense_mask(node_mask, graph_idx, node_slot, num_graphs, n_max)
            self.pair = self.valid[:, :, None] & self.valid[:, None, :]
        else:
            self.B, self.n = 1, graph_idx.shape[0]
            self.valid = node_mask[None]
            self.pair = _pair_mask(graph_idx, node_mask)[None]

    def pack(self, x):
        """[N, ...] -> [B, n, ...]"""
        if self.dense:
            return to_dense(x, self.graph_idx, self.node_slot, self.B, self.n)
        return x[None]

    def unpack(self, xb):
        """[B, n, ...] -> [N, ...] (padding rows zeroed)."""
        if self.dense:
            out = from_dense(xb, self.graph_idx, self.node_slot)
            keep = self.node_mask.reshape((-1,) + (1,) * (out.dim() - 1))
            return out * keep.to(out.dtype)
        return xb[0]

    def pair_no_self(self):
        if self.dense:
            eye = torch.eye(self.n, dtype=torch.bool, device=self.pair.device)[None]
            return self.pair & ~eye
        return _pair_mask(self.graph_idx, self.node_mask, exclude_self=True)[None]


def _rope_bias(pos, pair_mask, freqs, proj):
    """Per-head additive logit bias from Fourier features of the pair
    distances (reference :464-507); positions detached (reference :560).
    pos [B, n, 3], pair_mask [B, n, n] -> [B, H, n, n]."""
    pos = pos.detach()
    diff = pos[:, :, None, :] - pos[:, None, :, :]
    dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-12))
    bias = proj(torch.cos(dist[..., None] * torch.abs(freqs)))
    bias = torch.where(pair_mask[..., None], bias, torch.zeros_like(bias))
    return bias.movedim(-1, 1)


class _RopeBias(nn.Module):
    def __init__(self, num_heads: int, rope_dim: int = 16):
        super().__init__()
        self.rope_freqs = nn.Parameter(torch.empty(rope_dim))
        self.rope_proj = Linear(rope_dim, num_heads, bias=False)

    def forward(self, pos, pair_mask):
        return _rope_bias(pos, pair_mask, self.rope_freqs, self.rope_proj)


def _heads(t, p: _Packing, H: int):
    """[N, H D] -> [B, n, H, D]"""
    return p.pack(t).reshape(p.B, p.n, H, -1)


class GlobalScalarAttention(nn.Module):
    """MHSA on the l = 0 scalars: x [N, C] -> LN(x + attn_out) [N, C]."""

    def __init__(self, d_model: int, num_heads: int = 8, dropout: float = 0.0,
                 use_rope: bool = True, rope_dim: int = 16):
        super().__init__()
        self.d_model, self.H, self.use_rope = d_model, num_heads, use_rope
        self.dropout = dropout
        self.qkv_proj = Linear(d_model, 3 * d_model, bias=False)
        if use_rope:
            self.rope_freqs = nn.Parameter(torch.empty(rope_dim))
            self.rope_proj = Linear(rope_dim, num_heads, bias=False)
        self.out_proj = Linear(d_model, d_model, bias=False)
        self.norm = LayerNorm(d_model, eps=1e-5)

    def forward(self, x, graph_idx, node_mask, pos, node_slot=None, n_max: int | None = None,
                num_graphs: int | None = None, generator: torch.Generator | None = None):
        p = _Packing(graph_idx, node_mask, node_slot, n_max, num_graphs)
        q, k, v = (_heads(t, p, self.H) for t in self.qkv_proj(x).chunk(3, dim=-1))
        logits = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(q.shape[-1])
        if self.use_rope:
            logits = logits + _rope_bias(p.pack(pos), p.pair, self.rope_freqs, self.rope_proj)
        attn = _attn_dropout(_masked_softmax(logits, p.pair[:, None]), self.dropout,
                             self.training, generator)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(p.B, p.n, self.d_model)
        return self.norm(x + self.out_proj(p.unpack(out)))


class GlobalFullAttention(nn.Module):
    """MHSA over flattened (coeff x channel) vectors; breaks equivariance
    (ablation).  x [N, K, C] -> [N, K, C]."""

    def __init__(self, d_model: int, num_coeffs: int, num_heads: int = 8,
                 dropout: float = 0.0, use_rope: bool = True, rope_dim: int = 16):
        super().__init__()
        self.flat, self.H, self.use_rope = num_coeffs * d_model, num_heads, use_rope
        self.dropout = dropout
        self.qkv_proj = Linear(self.flat, 3 * self.flat, bias=False)
        if use_rope:
            self.rope = _RopeBias(num_heads, rope_dim)
        self.out_proj = Linear(self.flat, self.flat, bias=False)
        self.norm = LayerNorm(self.flat, eps=1e-5)

    def forward(self, x, graph_idx, node_mask, pos, node_slot=None, n_max: int | None = None,
                num_graphs: int | None = None, generator: torch.Generator | None = None):
        p = _Packing(graph_idx, node_mask, node_slot, n_max, num_graphs)
        xf = x.reshape(x.shape[0], self.flat)
        q, k, v = (_heads(t, p, self.H) for t in self.qkv_proj(xf).chunk(3, dim=-1))
        logits = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(q.shape[-1])
        if self.use_rope:
            logits = logits + self.rope(p.pack(pos), p.pair)
        attn = _attn_dropout(_masked_softmax(logits, p.pair[:, None]), self.dropout,
                             self.training, generator)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(p.B, p.n, self.flat)
        return self.norm(xf + self.out_proj(p.unpack(out))).reshape(x.shape)


class GlobalFullEquivariantAttention(nn.Module):
    """Per-degree attention: invariant Q / K from the degree norms,
    equivariant values.  x [N, (lmax+1)^2, C] -> same."""

    def __init__(self, sphere_channels: int, lmax: int, num_heads: int = 8,
                 dropout: float = 0.0):
        super().__init__()
        C = sphere_channels
        self.lmax, self.H, self.dropout = lmax, num_heads, dropout
        for l in range(lmax + 1):
            setattr(self, f"q_proj_{l}", Linear(C, C))
            setattr(self, f"k_proj_{l}", Linear(C, C))
            setattr(self, f"v_proj_{l}", Linear(C, C, bias=False))
            setattr(self, f"out_proj_{l}", Linear(C, C, bias=False))
            setattr(self, f"norm_{l}", LayerNorm(C, eps=1e-5))

    def forward(self, x, graph_idx, node_mask, pos=None, node_slot=None,
                n_max: int | None = None, num_graphs: int | None = None,
                generator: torch.Generator | None = None):
        """``pos`` is not read (the signature matches the other classes')."""
        p = _Packing(graph_idx, node_mask, node_slot, n_max, num_graphs)
        N, C = x.shape[0], x.shape[2]
        out = []
        for l in range(self.lmax + 1):
            feat = x[:, l * l : (l + 1) ** 2, :]
            norm = torch.sqrt(torch.clamp((feat * feat).sum(1), min=1e-12))
            q = _heads(getattr(self, f"q_proj_{l}")(norm), p, self.H)
            k = _heads(getattr(self, f"k_proj_{l}")(norm), p, self.H)
            v = p.pack(getattr(self, f"v_proj_{l}")(feat)).reshape(
                p.B, p.n, 2 * l + 1, self.H, -1)
            logits = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(q.shape[-1])
            attn = _attn_dropout(_masked_softmax(logits, p.pair[:, None]), self.dropout,
                                 self.training, generator)
            o = torch.einsum("bhij,bjmhd->bimhd", attn, v).reshape(p.B, p.n, 2 * l + 1, C)
            o = getattr(self, f"out_proj_{l}")(p.unpack(o))
            out.append(getattr(self, f"norm_{l}")(feat + o))
        return torch.cat(out, dim=1)


class GlobalHTRAttention(nn.Module):
    """HTR-score global attention (+ the distance RBF, + RoPE by flags).
    x [N, (lmax+1)^2, C] -> same."""

    def __init__(self, sphere_channels: int, lmax: int, num_heads: int = 8,
                 dropout: float = 0.0, use_distance: bool = False, num_rbf: int = 16,
                 rbf_cutoff: float = 10.0, use_rope: bool = False, rope_dim: int = 16):
        super().__init__()
        C = sphere_channels
        self.lmax, self.H, self.dropout = lmax, num_heads, dropout
        self.use_distance, self.use_rope = use_distance, use_rope
        self.num_rbf, self.rbf_cutoff = num_rbf, rbf_cutoff
        if use_distance:
            self.rbf_proj = Linear(num_rbf, C, bias=False)
        self.q_proj = Linear(C, C)
        self.k_proj = Linear(C, C)
        if use_rope:
            self.rope = _RopeBias(num_heads, rope_dim)
        for l in range(lmax + 1):
            setattr(self, f"v_proj_{l}", Linear(C, C, bias=l == 0))
            setattr(self, f"out_proj_{l}", Linear(C, C, bias=False))
            setattr(self, f"norm_{l}", LayerNorm(C, eps=1e-5))

    def forward(self, x, graph_idx, node_mask, pos, node_slot=None, n_max: int | None = None,
                num_graphs: int | None = None, generator: torch.Generator | None = None):
        p = _Packing(graph_idx, node_mask, node_slot, n_max, num_graphs)
        C = x.shape[2]
        pm_noself = p.pair_no_self()

        # pairwise directions of the detached geometry: [B, n, n, 3]
        posd = p.pack(pos.detach())
        diff = posd[:, :, None, :] - posd[:, None, :, :]
        dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=1e-16))
        r_hat = diff / torch.clamp(dist, min=1e-8)[..., None]
        sh = real_sph_harm(self.lmax, r_hat, normalization="norm")    # [B, n, n, K]

        dt = torch.promote_types(x.dtype, sh.dtype)
        xb, sh = p.pack(x).to(dt), sh.to(dt)                         # [B, n, K, C]
        score = None
        for l in range(self.lmax + 1):
            sl = slice(l * l, (l + 1) ** 2)
            ip = torch.einsum("bimc,bijm->bijc", xb[:, :, sl, :], sh[..., sl])
            score = ip / (2 * l + 1) if score is None else score + ip / (2 * l + 1)
        if self.use_distance:
            centers = torch.linspace(0.0, self.rbf_cutoff, self.num_rbf, device=x.device)
            width = (self.rbf_cutoff / self.num_rbf) ** 2
            rbf = torch.exp(-((dist[..., None] - centers) ** 2) / width)
            score = score + self.rbf_proj(rbf)
        score = torch.where(pm_noself[..., None], score, torch.zeros_like(score))

        # masked means over the valid pairs (the reference's plain mean
        # divides by the padded axis length)
        cnt_j = torch.clamp(pm_noself.sum(2).to(score.dtype), min=1.0)[..., None]
        cnt_i = torch.clamp(pm_noself.sum(1).to(score.dtype), min=1.0)[..., None]
        q = self.q_proj(score.sum(2) / cnt_j).reshape(p.B, p.n, self.H, -1)
        k = self.k_proj(score.sum(1) / cnt_i).reshape(p.B, p.n, self.H, -1)
        logits = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(q.shape[-1])
        if self.use_rope:
            logits = logits + self.rope(posd, p.pair)
        attn = _attn_dropout(_masked_softmax(logits, p.pair[:, None]), self.dropout,
                             self.training, generator)

        out = []
        for l in range(self.lmax + 1):
            feat = x[:, l * l : (l + 1) ** 2, :]
            v = p.pack(getattr(self, f"v_proj_{l}")(feat)).reshape(
                p.B, p.n, 2 * l + 1, self.H, -1)
            o = torch.einsum("bhij,bjmhd->bimhd", attn, v).reshape(p.B, p.n, 2 * l + 1, C)
            o = getattr(self, f"out_proj_{l}")(p.unpack(o))
            out.append(getattr(self, f"norm_{l}")(feat + o))
        return torch.cat(out, dim=1)
