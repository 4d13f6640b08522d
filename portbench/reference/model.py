"""Plain PyTorch reference of EquiformerV2 as a configuration file states it:
the GATA-V2 edge stream or the baseline attention (``gata``), the value
activation's alpha scaling (``normalize_attn_output``) and distance gate
(``use_phi_every_layer``); an energy head per atom or over
``avg_num_nodes``, forces by autograd (with the per-graph stress when asked)
or from an explicit force head (the configuration's ``outputs``).  A model
key that this module does not implement is refused: a configuration that
needs one names its own reference module (``reference`` in its file).

A ragged graph (``edges``: src, dst, integer cell shifts, from
``reference/neighbors.py``), float32 throughout, weights in a dict under the
names of the model's ``state_dict``.  Segment sums are ``index_add``, the
softmax over a node's incoming edges is taken per node, every rotation is a
per-degree product with the Wigner-D blocks of ``geometry.wigner_blocks``.
``Numerics`` can round the operands of every product to a lower precision
(the benchmark's control).  Imports nothing of the program.

Departures from the published EquiformerV2, kept because the model under test
has them: the GATA value activation takes the first ``min(2l+1, 2 mmax+1)``
rows of each degree; the m = 0 rows alone enter the GATA attention's first
SO(2) convolution; the inverse rotation rescales degrees above mmax by
sqrt((2l+1)/(2 mmax+1)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import Layout, grid_tables, real_sph_harm, wigner_blocks

__all__ = ["Numerics", "Model", "F32", "ARCH_DEFAULTS", "OUTPUTS"]

# the switches this module implements, with the program's defaults
ARCH_DEFAULTS = dict(gata=True, normalize_attn_output=True, use_phi_every_layer=False)
# widths and constants
_SIZES = {"num_layers", "sphere_channels", "attn_hidden_channels", "num_heads",
          "attn_alpha_channels", "attn_value_channels", "ffn_hidden_channels", "lmax", "mmax",
          "grid_resolution", "edge_channels", "num_rbf", "max_num_elements", "cutoff",
          "avg_degree", "avg_num_nodes"}
# keys that change how the program computes, not what (kernels, layouts,
# recompute), or that act only with an option refused below
_NEUTRAL = {"conv_fused", "wigner_rep", "remat", "num_experts", "global_attn_heads",
            "global_attn_dense_n_max"}
# keys implemented only at these values (dropouts off; the program's other defaults)
_FIXED = dict(alpha_drop=0.0, drop_path_rate=0.0, proj_drop=0.0, norm_type="rms_norm_sh",
              use_atom_edge_embedding=True, share_atom_edge_embedding=False,
              use_m_share_rad=False, use_attn_renorm=True, use_gate_act=False,
              use_grid_mlp=False, use_sep_s2_act=True, gata_v1=False, ffn_variant="standard",
              dual_stream=False, global_attn=None)
# outputs: energy per atom or over avg_num_nodes; forces by autograd or a head
OUTPUTS = {"energy": ("per_atom", "per_avg_num_nodes"), "forces": ("gradient", "head")}


def _check_keys(cfg: dict, outputs: dict) -> None:
    """Refuse what this reference does not compute."""
    for k, v in cfg.items():
        if k in _SIZES or k in _NEUTRAL or k in ARCH_DEFAULTS:
            continue
        if k not in _FIXED:
            raise NotImplementedError(f"the reference does not implement the model key {k!r}")
        if v != _FIXED[k]:
            raise NotImplementedError(f"the reference implements {k}={_FIXED[k]!r} only, "
                                      f"not {v!r}")
    for k, allowed in OUTPUTS.items():
        if outputs.get(k) not in allowed:
            raise NotImplementedError(f"outputs[{k!r}] = {outputs.get(k)!r}: one of {allowed}")


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (amax onto 448), back in float32."""
    x = x.float()
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class _Round(torch.autograd.Function):
    """``fwd`` on the value, ``bwd`` on its gradient (None: unrounded)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x) if fwd is not None else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (ctx.bwd(g) if ctx.bwd is not None else g), None, None


@dataclass(frozen=True)
class Numerics:
    """The precision of the products.

    ``"f32"``: float32, TF32 off.  ``"tf32"``: the operands of every product
    rounded to TF32 in the forward and the backward (the gradient entering a
    product's backward is rounded where the product's output is), the results
    float32, as the tensor cores compute with TF32 on; ``geometry``: the
    Wigner blocks too.  ``"fp8"``: compute in float8 e4m3 with one scale per
    tensor: every product's operands and result rounded, and so every
    gradient, in both passes."""

    products: str = "f32"
    geometry: bool = False

    def _fn(self):
        return _round_tf32 if self.products == "tf32" else _round_fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand."""
        if self.products == "f32":
            return x
        return _Round.apply(x, self._fn(), self._fn() if self.products == "fp8" else None)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's result."""
        if self.products == "f32":
            return y
        return _Round.apply(y, self._fn() if self.products == "fp8" else None, self._fn())

    def qg(self, x: torch.Tensor) -> torch.Tensor:
        return self.q(x) if self.geometry else x


F32 = Numerics()


def _segment_sum(x: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n,) + tuple(x.shape[1:])).index_add(0, index, x)


def _segment_softmax(logits: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Softmax over the edges of each target node; logits [E, H]."""
    mx = logits.new_full((n, logits.shape[1]), -torch.inf).scatter_reduce(
        0, index[:, None].expand_as(logits), logits.detach(), "amax", include_self=True)
    e = torch.exp(logits - mx[index])
    return e / _segment_sum(e, index, n)[index]


class Model:
    """The reference forward of one configuration (``cfg``: the model keys of
    the benchmark's configuration file; ``outputs``: its ``outputs``, the
    energy head's normalisation and where the forces come from)."""

    def __init__(self, cfg: dict, outputs: dict, numerics: Numerics = F32):
        _check_keys(cfg, outputs)
        self.c = cfg
        self.outputs = dict(outputs)
        self.nx = numerics
        arch = {**ARCH_DEFAULTS, **{k: cfg[k] for k in ARCH_DEFAULTS if k in cfg}}
        self.gata = bool(arch["gata"])
        self.normalize_attn_output = bool(arch["normalize_attn_output"])
        self.use_phi = bool(arch["use_phi_every_layer"])
        self.grad_forces = outputs["forces"] == "gradient"
        L, M = cfg["lmax"], cfg["mmax"]
        self.lay_full, self.lay_red = Layout(L, L), Layout(L, M)
        self.grid_res = cfg.get("grid_resolution")
        self._tables = {}

    # ── products ────────────────────────────────────────────────────────
    def lin(self, x, W: dict, name: str, bias: bool = True):
        y = self.nx.out(self.nx.q(x) @ self.nx.q(W[name + ".weight"]).t())
        return y + W[name + ".bias"] if bias else y

    def so3(self, x, W, name):
        """Per-degree linear map, bias on l = 0: x [N, K_full, C]."""
        w = W[name + ".weight"]
        out = [self.nx.out(self.nx.q(x[:, l * l:(l + 1) ** 2]) @ self.nx.q(w[l]))
               for l in range(self.c["lmax"] + 1)]
        out[0] = out[0] + W[name + ".bias"]
        return torch.cat(out, 1)

    def radial(self, x, W, name, n_lin: int = 3):
        for i in range(n_lin):
            x = self.lin(x, W, f"{name}.linears.{i}")
            if i < n_lin - 1:
                x = F.silu(F.layer_norm(x, x.shape[-1:], W[f"{name}.norms.{i}.weight"],
                                        W[f"{name}.norms.{i}.bias"], 1e-5))
        return x

    def grid(self, lmax, mmax, device):
        key = (lmax, mmax, str(device))
        if key not in self._tables:
            to_g, from_g = grid_tables(lmax, mmax, self.grid_res)
            self._tables[key] = (torch.as_tensor(to_g, dtype=torch.float32, device=device),
                                 torch.as_tensor(from_g, dtype=torch.float32, device=device))
        return self._tables[key]

    def s2_act(self, x, lmax, mmax):
        """from_grid(silu(to_grid(x))) on [N, K, C]."""
        to_g, from_g = self.grid(lmax, mmax, x.device)
        g = F.silu(self.nx.out(self.nx.q(to_g) @ self.nx.q(x)))
        return self.nx.out(self.nx.q(from_g.t()) @ self.nx.q(g))

    # ── rotations ───────────────────────────────────────────────────────
    def to_edge(self, D, x, m0_only=False):
        """[E, K_full, C] -> the edge frame: [E, K_red, C] (``m0_only``: the
        m = 0 row of each degree, [E, lmax+1, C])."""
        out = []
        for l, d in enumerate(D):
            rows = [l] if m0_only else self.lay_red.kept_rows(l)
            out.append(self.nx.out(self.nx.qg(d[:, rows, :])
                                   @ self.nx.q(x[:, l * l:(l + 1) ** 2])))
        return torch.cat(out, 1)

    def from_edge(self, D, x):
        """[E, K_red, C] in the edge frame -> [E, K_full, C]."""
        out, off, M = [], 0, self.c["mmax"]
        for l, d in enumerate(D):
            rows = self.lay_red.kept_rows(l)
            dt = d[:, rows, :].transpose(1, 2)
            if l > M:
                dt = dt * math.sqrt((2 * l + 1) / (2 * M + 1))
            out.append(self.nx.out(self.nx.qg(dt) @ self.nx.q(x[:, off:off + len(rows)])))
            off += len(rows)
        return torch.cat(out, 1)

    # ── SO(2) convolution ───────────────────────────────────────────────
    def so2(self, x, W, name, cin, cout, extra=0, rad=None, m0_only=False):
        """x [E, K_red, cin] (``m0_only``: [E, lmax+1, cin]) -> (out, extra);
        the per-(l, m) radial scales ``rad`` [E, sum_m L_m * cin]."""
        L0 = self.c["lmax"] + 1
        E = x.shape[0]
        xm = x if m0_only else x[:, self.lay_red.to_m]
        x0 = xm[:, :L0].reshape(E, L0 * cin)
        if rad is not None:
            x0 = x0 * rad[:, :L0 * cin]
        w0, b0 = W[name + ".w_m0"], W[name + ".b_m0"]
        if m0_only:
            return None, self.nx.out(self.nx.q(x0) @ self.nx.q(w0[:, :extra])) + b0[:extra]
        y0 = self.nx.out(self.nx.q(x0) @ self.nx.q(w0)) + b0
        ex, y0 = y0[:, :extra], y0[:, extra:]
        blocks = [y0.reshape(E, L0, cout)]
        off, roff = L0, L0 * cin
        for m in range(1, self.c["mmax"] + 1):
            Lm = L0 - m
            xr = xm[:, off:off + Lm].reshape(E, Lm * cin)
            xi = xm[:, off + Lm:off + 2 * Lm].reshape(E, Lm * cin)
            if rad is not None:
                r = rad[:, roff:roff + Lm * cin]
                xr, xi, roff = xr * r, xi * r, roff + Lm * cin
            wr, wi = self.nx.q(W[f"{name}.w_m{m}_r"]), self.nx.q(W[f"{name}.w_m{m}_i"])
            xr, xi = self.nx.q(xr), self.nx.q(xi)
            # (xr + i xi)(wr + i wi)
            yr = self.nx.out(xr @ wr) - self.nx.out(xi @ wi)
            yi = self.nx.out(xr @ wi) + self.nx.out(xi @ wr)
            blocks.append(torch.cat([yr.reshape(E, Lm, cout), yi.reshape(E, Lm, cout)], 1))
            off += 2 * Lm
        return torch.cat(blocks, 1)[:, self.lay_red.from_m], (ex if extra else None)

    # ── blocks ──────────────────────────────────────────────────────────
    def rms_norm(self, x, W, name):
        """Joint RMS over degrees (each degree's power averaged over its 2l+1
        rows), l = 0 centred, per-degree scale, bias on l = 0."""
        L = self.c["lmax"]
        l0 = x[:, :1]
        x = torch.cat([l0 - l0.mean(2, keepdim=True), x[:, 1:]], 1)
        bal = torch.cat([torch.full((2 * l + 1,), 1.0 / ((2 * l + 1) * (L + 1)))
                         for l in range(L + 1)]).to(x.device)
        var = torch.einsum("nkc,k->nc", x * x, bal).mean(1)
        deg = torch.as_tensor(np.repeat(np.arange(L + 1), [2 * l + 1 for l in range(L + 1)]),
                              device=x.device)
        out = x * (var[:, None, None] + 1e-5) ** -0.5 * W[name + ".weight"][deg][None]
        return torch.cat([out[:, :1] + W[name + ".bias"], out[:, 1:]], 1)

    def ffn(self, x, W, name, cout):
        """SO3 linear -> separable S2 activation -> SO3 linear."""
        L = self.c["lmax"]
        gate = self.lin(x[:, 0], W, name + ".gating_linear")
        h = self.so3(x, W, name + ".so3_linear_1")
        h = torch.cat([F.silu(gate)[:, None], self.s2_act(h, L, L)[:, 1:]], 1)
        return self.so3(h, W, name + ".so3_linear_2")

    def alpha(self, a_in, W, name, dst, n):
        c = self.c
        a = a_in.reshape(-1, c["num_heads"], c["attn_alpha_channels"])
        a = F.layer_norm(a, a.shape[-1:], W[name + ".alpha_norm.weight"],
                         W[name + ".alpha_norm.bias"], 1e-5)
        a = 0.6 * a + 0.4 * a * (2 * torch.sigmoid(a) - 1)     # smooth leaky ReLU, slope 0.2
        logits = self.nx.out(torch.einsum("ehk,hk->eh", self.nx.q(a),
                                          self.nx.q(W[name + ".alpha_dot"])))
        return _segment_softmax(logits, dst, n)

    def attention(self, x, W, name, g, t_ij, cout):
        """Graph attention on the edges of ``g`` (GATA-V2 or the baseline)."""
        c, L, M = self.c, self.c["lmax"], self.c["mmax"]
        C, H = c["sphere_channels"], c["attn_hidden_channels"]
        heads, A, V = c["num_heads"], c["attn_alpha_channels"], c["attn_value_channels"]
        src, dst, n = g["src"], g["dst"], x.shape[0]
        x_edge = torch.cat([g["rbf"], W[name + ".src_embedding.weight"][g["z"][src]],
                            W[name + ".dst_embedding.weight"][g["z"][dst]]], 1)
        x_src, x_dst = x[src], x[dst]
        msg = torch.cat([x_src, x_dst], 2)
        rad = self.radial(x_edge, W, name + ".so2_conv_1.rad")
        if self.gata:
            S = 1 + 2 * L
            _, y0 = self.so2(self.to_edge(g["D"], msg, m0_only=True), W, name + ".so2_conv_1",
                             2 * C, H, extra=heads * A + S * H, rad=rad, m0_only=True)
            alpha = self.alpha(y0[:, :heads * A], W, name, dst, n)
            comb = y0[:, heads * A:]
            if self.normalize_attn_output:
                comb = comb * alpha.mean(1, keepdim=True)
            va = name + ".value_act"
            bias = (self.lin(t_ij, W, va + ".W_rs")
                    * F.silu(self.lin(x_dst[:, 0], W, va + ".gamma_s")))
            if self.use_phi:
                bias = bias * self.lin(g["rbf"], W, va + ".phi_proj")
            comb = comb + bias
            Xp = self.lin(x_dst[:, 1:], W, va + ".xj_proj", bias=False)
            out, off = [F.silu(comb[:, :H])[:, None]], 0
            for l in range(1, L + 1):
                d, w = 2 * l + 1, min(2 * l + 1, 2 * M + 1)
                od = comb[:, l * H:(l + 1) * H][:, None]
                ot = comb[:, (L + l) * H:(L + l + 1) * H][:, None]
                out.append(od * g["rl"][:, off:off + w, None] + ot * Xp[:, off:off + w])
                off += d
            msg = torch.cat(out, 1)
        else:
            msg, y0 = self.so2(self.to_edge(g["D"], msg), W, name + ".so2_conv_1", 2 * C, H,
                               extra=heads * A + H, rad=rad)
            alpha = self.alpha(y0[:, :heads * A], W, name, dst, n)
            msg = torch.cat([F.silu(y0[:, heads * A:])[:, None],
                             self.s2_act(msg, L, M)[:, 1:]], 1)
        msg, _ = self.so2(msg, W, name + ".so2_conv_2", H, heads * V)
        E, K = msg.shape[:2]
        msg = (msg.reshape(E, K, heads, V) * alpha[:, None, :, None]).reshape(E, K, heads * V)
        msg = self.from_edge(g["D"], msg)
        return self.so3(_segment_sum(msg, dst, n), W, name + ".proj")

    def htr(self, t_ij, x, W, name, g):
        L = self.c["lmax"]
        X_i, X_j = x[g["src"]][:, 1:], x[g["dst"]][:, 1:]
        q = self.lin(X_i, W, name + ".W_vq", bias=False)
        w_ij, off = 0.0, 0
        for l in range(1, L + 1):
            d = 2 * l + 1
            rl = g["rl"][:, off:off + d, None]
            qi, kj = q[:, off:off + d], self.lin(X_j[:, off:off + d], W, f"{name}.W_vk_{l}",
                                                 bias=False)
            # < (I - r r^T) qi, (I - r r^T) kj > with |r| = 1
            rej_q, rej_k = qi - rl * (qi * rl).sum(1, keepdim=True), kj - rl * (kj * rl).sum(
                1, keepdim=True)
            w_ij = w_ij + (rej_q * rej_k).sum(1) / d
            off += d
        gw = F.silu(self.lin(w_ij, W, name + ".gamma_w"))
        gt = F.silu(self.lin(F.silu(self.lin(t_ij, W, name + ".gamma_t_1")), W,
                             name + ".gamma_t_2"))
        return t_ij + gw * gt

    # ── the model ───────────────────────────────────────────────────────
    def graph(self, W, z, pos, cell_e, src, dst, shift, strain_e=None):
        """Edge geometry: displacement, RBF, Wigner blocks, edge SH.
        ``strain_e`` [E, 3, 3]: I + the strain of each edge's graph, which
        deforms positions and cell alike, so the displacement too."""
        c = self.c
        dvec = pos[dst] + torch.einsum("ek,ekj->ej", shift, cell_e) - pos[src]
        if strain_e is not None:
            dvec = torch.einsum("ek,ekj->ej", dvec, strain_e)
        dist = torch.sqrt(torch.clamp((dvec * dvec).sum(-1), min=1e-12))
        offs = torch.linspace(0.0, c["cutoff"], c["num_rbf"], dtype=torch.float64)
        coeff = -0.5 / float(2.0 * (offs[1] - offs[0])) ** 2
        rbf = torch.exp(coeff * (dist[:, None] - offs.float().to(pos.device)) ** 2)
        g = dict(z=z, src=src, dst=dst, rbf=rbf, D=wigner_blocks(c["lmax"], dvec))
        if self.gata:
            unit = dvec / dist[:, None]
            g["rl"] = real_sph_harm(c["lmax"], unit.detach(), "norm")[:, 1:]
        return g

    def backbone(self, W, z, pos, cell_e, src, dst, shift, strain_e=None):
        c = self.c
        L, C = c["lmax"], c["sphere_channels"]
        n = z.shape[0]
        g = self.graph(W, z, pos, cell_e, src, dst, shift, strain_e)
        p = "backbone."
        e = p + "edge_degree_embedding"
        x_edge = torch.cat([g["rbf"], W[e + ".src_embedding.weight"][z[src]],
                            W[e + ".dst_embedding.weight"][z[dst]]], 1)
        m0 = self.radial(x_edge, W, e + ".rad").reshape(-1, L + 1, C)
        emb = m0.new_zeros(m0.shape[0], self.lay_red.K, C)
        emb[:, self.lay_red.m0_rows] = m0
        deg = _segment_sum(self.from_edge(g["D"], emb), dst, n) / c["avg_degree"]
        x = torch.cat([W[p + "sphere_embedding.weight"][z][:, None],
                       pos.new_zeros(n, (L + 1) ** 2 - 1, C)], 1) + deg
        t_ij = None
        if self.gata:
            h = x[:, 0]
            t_ij = (self.lin(h[src] + h[dst], W, p + "h_proj")
                    * self.lin(g["rbf"], W, p + "W_erp"))
        for i in range(c["num_layers"]):
            b = f"{p}blocks.{i}"
            if self.gata:
                t_ij = self.htr(t_ij, x, W, b + ".htr", g)
            x = x + self.attention(self.rms_norm(x, W, b + ".attn_norm"), W, b + ".ga", g,
                                   t_ij, C)
            x = x + self.ffn(self.rms_norm(x, W, b + ".ffn_norm"), W, b + ".ffn", C)
        return self.rms_norm(x, W, p + "norm"), g

    def forward(self, W, batch: dict, strain=None) -> dict:
        """``batch``: z [N], pos [N, 3], graph [N], cell [B, 3, 3], src / dst [E],
        shift [E, 3] (float), natoms [B]; ``strain`` [B, 3, 3] or None.  The
        energy [B] (per atom or over ``avg_num_nodes``) and the total [B];
        with a force head the forces [N, 3] too."""
        z, pos, gi = batch["z"], batch["pos"], batch["graph"]
        src, dst = batch["src"], batch["dst"]
        B = batch["cell"].shape[0]
        strain_e = None
        if strain is not None:
            strain_e = (torch.eye(3, device=pos.device) + strain)[gi[dst]]
        x, g = self.backbone(W, z, pos, batch["cell"][gi[dst]], src, dst, batch["shift"],
                             strain_e)
        node_e = self.ffn(x, W, "energy_block", 1)[:, 0, 0]
        total = _segment_sum(node_e, gi, B)
        if self.outputs["energy"] == "per_atom":
            out = {"energy": total / batch["natoms"].to(total.dtype), "energy_total": total}
        else:
            out = {"energy": total / self.c["avg_num_nodes"], "energy_total": total}
        if not self.grad_forces:
            f = self.attention(x, W, "force_block", g, None, 1)
            out["forces"] = f[:, [3, 1, 2], 0]
        return out

    def energy_forces(self, W, batch: dict, create_graph: bool = False,
                      stress: bool = False) -> dict:
        """Energies and forces -dE_total/dpos; with ``stress`` the per-graph
        stress [B, 6] (Voigt xx, yy, zz, yz, xz, xy): sym(dE_total/d strain)
        over |det cell|.  A model with a force head returns its forward."""
        if not self.grad_forces:
            if stress:
                raise NotImplementedError("the stress is computed with forces by autograd")
            return self.forward(W, batch)
        pos = batch["pos"].detach().requires_grad_(True)
        with torch.enable_grad():
            if not stress:
                out = self.forward(W, {**batch, "pos": pos})
                (dpos,) = torch.autograd.grad(out["energy_total"].sum(), pos,
                                              create_graph=create_graph)
                return {**out, "forces": -dpos}
            strain = torch.zeros_like(batch["cell"], requires_grad=True)
            out = self.forward(W, {**batch, "pos": pos}, strain)
            dpos, dstrain = torch.autograd.grad(out["energy_total"].sum(), (pos, strain),
                                                create_graph=create_graph)
        sym = 0.5 * (dstrain + dstrain.transpose(-1, -2))
        s = sym / torch.abs(torch.linalg.det(batch["cell"]))[:, None, None]
        voigt = torch.stack([s[:, 0, 0], s[:, 1, 1], s[:, 2, 2], s[:, 1, 2], s[:, 0, 2],
                             s[:, 0, 1]], 1)
        return {**out, "forces": -dpos, "stress": voigt}
