"""Weight import: a reference (PyTorch EquiformerV2) ``state_dict`` -> the
port's ``state_dict``.

The port's own copy of the JAX package's utils/port.py, which maps the
reference's parameter layouts onto the Flax modules; the port then reads
that Flax-shaped tree through utils/convert.py (``flax_to_state_dict``), so
both packages load a reference checkpoint through one mapping:

* ``SO3_LinearV2``  (reference so3.py:698-739, weight [L+1, C_out, C_in],
  bias [C_out])                       -> ``SO3Linear`` (weight [L+1, C_in,
  C_out], bias)
* ``SO2_Convolution`` (reference so2_ops.py:64-204: ``fc_m0`` Linear with
  extra-m0 channels first, per-m ``SO2_m_Convolution.fc`` Linear whose output
  stacks [W_r; W_i])                  -> ``SO2Conv`` (w_m0/b_m0, per-m
  w_r/w_i)
* ``RadialFunction`` (reference radial_function.py:5-30,
  Linear->LayerNorm->SiLU chain)      -> ``RadialMLP``
* the norms, HTR, the GATA value activation, the edge-degree embedding,
  the FFN, the graph attention and the block; ``port_backbone`` the trunk.

Coefficient-ordering compatibility: both sides use the same m-primary order
(+m block then -m block, l ascending within each; reference
CoefficientMappingModule so3.py:45-153 vs ops/irreps.py), so weights port
without permutation.

The part functions return the Flax-shaped tree (nested dicts of numpy
arrays, the JAX package's names); ``port_matpes_model`` and
``port_qm9_model`` return the port's ``state_dict``, which
``load_state_dict(strict=True)`` of ``EquiformerV2MatPES`` /
``EquiformerV2QM9`` takes.  Inputs are ``name -> array`` dicts (a torch
``state_dict`` works: tensors are converted).
"""

from __future__ import annotations

import numpy as np

from .convert import flax_to_state_dict

__all__ = [
    "port_so3_linear",
    "port_so2_conv",
    "port_radial_mlp",
    "port_norm",
    "port_htr",
    "port_gata_value_activation",
    "port_edge_degree_embedding",
    "port_ffn",
    "port_graph_attention",
    "port_trans_block",
    "port_backbone",
    "port_matpes_model",
    "port_qm9_model",
]


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def port_so3_linear(sd: dict, prefix: str = "") -> dict:
    """Reference SO3_LinearV2 params -> flax SO3Linear params.

    Reference: ``{prefix}weight`` [(L+1), C_out, C_in], ``{prefix}bias``
    [C_out] (so3.py:710-714).  Ours: weight [(L+1), C_in, C_out] + bias.
    """
    w = _np(sd[prefix + "weight"])
    out = {"weight": np.transpose(w, (0, 2, 1))}
    if prefix + "bias" in sd:
        out["bias"] = _np(sd[prefix + "bias"])
    else:
        out["bias"] = np.zeros(w.shape[1], w.dtype)
    return out


def port_so2_conv(sd: dict, prefix: str = "", mmax: int | None = None) -> dict:
    """Reference SO2_Convolution params -> flax SO2Conv params.

    Reference naming (so2_ops.py:64-134):
      ``fc_m0.weight`` [extra + L0*C_out, L0*C_in], ``fc_m0.bias``;
      ``so2_m_conv.{m-1}.fc.weight`` [2*Lm*C_out, Lm*C_in] stacking
      [W_r; W_i] along the output dim (so2_ops.py:47-59);
      optional ``rad_func.*`` RadialFunction (ported separately with
      :func:`port_radial_mlp` under the flax submodule "RadialMLP_0").
    """
    out = {
        "w_m0": _np(sd[prefix + "fc_m0.weight"]).T,
        "b_m0": _np(sd[prefix + "fc_m0.bias"]),
    }
    m = 1
    while True:
        key = f"{prefix}so2_m_conv.{m - 1}.fc.weight"
        if key not in sd or (mmax is not None and m > mmax):
            break
        w = _np(sd[key])                 # [2*Lm*C_out, Lm*C_in]
        half = w.shape[0] // 2
        out[f"w_m{m}_r"] = w[:half].T    # [Lm*C_in, Lm*C_out]
        out[f"w_m{m}_i"] = w[half:].T
        m += 1
    if prefix + "rad_func.net.0.weight" in sd:
        out["RadialMLP_0"] = port_radial_mlp(sd, prefix + "rad_func.")
    return out


def port_radial_mlp(sd: dict, prefix: str = "") -> dict:
    """Reference RadialFunction params -> flax RadialMLP params.

    Reference Sequential: net.0 Linear, net.1 LayerNorm, net.2 SiLU,
    net.3 Linear, ... (radial_function.py:10-27).  Flax: Dense_i +
    LayerNorm_i pairs.
    """
    idxs = sorted(
        int(k[len(prefix) + 4 :].split(".")[0])
        for k in sd
        if k.startswith(prefix + "net.") and k.endswith(".weight")
    )
    out = {}
    i_dense = 0
    i_ln = 0
    for j in idxs:   # SiLU entries have no params and are simply absent
        w = _np(sd[f"{prefix}net.{j}.weight"])
        b = _np(sd[f"{prefix}net.{j}.bias"])
        if w.ndim == 2:      # Linear
            out[f"Dense_{i_dense}"] = {"kernel": w.T, "bias": b}
            i_dense += 1
        else:                # LayerNorm (1-D weight)
            out[f"LayerNorm_{i_ln}"] = {"scale": w, "bias": b}
            i_ln += 1
    return out


def port_norm(sd: dict, kind: str, prefix: str = "") -> dict:
    """Reference equivariant-norm params -> flax norm params.

    Reference layer_norm.py naming:
      * ``layer_norm`` (EquivariantLayerNormArray:38-108):
        ``affine_weight`` [lmax+1, C], ``affine_bias`` [C]
        -> :class:`nn.norms.EquivariantLayerNorm` {weight, bias}
      * ``layer_norm_sh`` (…ArraySphericalHarmonics:112-201):
        ``norm_l0.{weight,bias}`` torch LayerNorm + ``affine_weight``
        [lmax, C] -> :class:`nn.norms.EquivariantLayerNormSH`
        {LayerNorm_0: {scale, bias}, weight}
      * ``rms_norm_sh`` (…RMSNormArraySphericalHarmonicsV2:265-351):
        ``affine_weight`` [lmax+1, C], ``affine_bias`` [C]
        -> :class:`nn.norms.EquivariantRMSNormSH` {weight, bias}
      * ``rms_norm_sh_v1`` (…RMSNormArraySphericalHarmonics:204-262):
        ``affine_weight`` only -> EquivariantRMSNormSH(centering=False,
        std_balance_degrees=False) {weight}
      * ``degree_layer_scale`` (EquivariantDegreeLayerScale:354-380):
        ``affine_weight`` [1, lmax+1, C] -> {weight [lmax+1, C]}
    """
    w = _np(sd[prefix + "affine_weight"]) if prefix + "affine_weight" in sd \
        else None
    if kind == "layer_norm":
        return {"weight": w, "bias": _np(sd[prefix + "affine_bias"])}
    if kind == "layer_norm_sh":
        return {
            "LayerNorm_0": {
                "scale": _np(sd[prefix + "norm_l0.weight"]),
                "bias": _np(sd[prefix + "norm_l0.bias"]),
            },
            "weight": w,
        }
    if kind == "rms_norm_sh":
        out = {"weight": w}
        if prefix + "affine_bias" in sd:
            out["bias"] = _np(sd[prefix + "affine_bias"])
        return out
    if kind == "rms_norm_sh_v1":
        return {"weight": w}
    if kind == "degree_layer_scale":
        return {"weight": w.reshape(w.shape[-2], w.shape[-1])}
    raise ValueError(kind)


def _dense(sd, key):
    out = {"kernel": _np(sd[key + ".weight"]).T}
    if key + ".bias" in sd:
        out["bias"] = _np(sd[key + ".bias"])
    return out


def port_htr(sd: dict, lmax: int, prefix: str = "") -> dict:
    """Reference HTR params -> flax :class:`nn.gata.HTR` params.

    Reference Gotennet_morethaninspired/activation.py:166-264: ``W_vq``
    Linear (no bias), ``W_vk.{i}`` ModuleList (i = l-1), ``gamma_w``
    Sequential(Linear, SiLU), ``gamma_t`` Sequential(Linear, SiLU, Linear,
    SiLU).
    """
    out = {"W_vq": _dense(sd, prefix + "W_vq")}
    for l in range(1, lmax + 1):
        out[f"W_vk_{l}"] = _dense(sd, f"{prefix}W_vk.{l - 1}")
    out["gamma_w"] = _dense(sd, prefix + "gamma_w.0")
    out["gamma_t_1"] = _dense(sd, prefix + "gamma_t.0")
    out["gamma_t_2"] = _dense(sd, prefix + "gamma_t.2")
    return out


def port_gata_value_activation(sd: dict, prefix: str = "") -> dict:
    """Reference GATAValueActivation params -> flax
    :class:`nn.gata.GATAValueActivation` params (activation.py:270-414:
    ``W_rs`` Linear, ``gamma_s`` Sequential(Linear, SiLU), ``xj_proj``
    Linear no-bias)."""
    return {
        "W_rs": _dense(sd, prefix + "W_rs"),
        "gamma_s": _dense(sd, prefix + "gamma_s.0"),
        "xj_proj": _dense(sd, prefix + "xj_proj"),
    }


def port_ffn(sd: dict, prefix: str = "", use_grid_mlp: bool = False,
             use_sep_s2_act: bool = True, use_gate_act: bool = False) -> dict:
    """Reference FeedForwardNetwork params -> flax :class:`nn.ffn.FeedForward`
    (reference transformer_block.py:339-453 / the GATA fork :373-470)."""
    out = {
        "so3_linear_1": port_so3_linear(sd, prefix + "so3_linear_1."),
        "so3_linear_2": port_so3_linear(sd, prefix + "so3_linear_2."),
    }
    if use_grid_mlp:
        if use_sep_s2_act:
            out["scalar_mlp"] = _dense(sd, prefix + "scalar_mlp.0")
        for i, j in enumerate((0, 2, 4)):
            out[f"grid_mlp_{i}"] = _dense(sd, f"{prefix}grid_mlp.{j}")
    elif use_gate_act or use_sep_s2_act:
        out["gating_linear"] = _dense(sd, prefix + "gating_linear")
    return out


def port_graph_attention(sd: dict, lmax: int, mmax: int, prefix: str = "",
                         gata: bool = False,
                         use_atom_edge_embedding: bool = True,
                         has_rad: bool = True) -> dict:
    """Reference SO2EquivariantGraphAttention params -> flax
    :class:`nn.attention.GraphAttention` (baseline transformer_block.py:40-336
    and the GATA fork Gotennet_morethaninspired/transformer_block.py:50-366).
    """
    out = {}
    if use_atom_edge_embedding:
        out["Embed_0"] = {
            "embedding": _np(sd[prefix + "source_embedding.weight"])
        }
        out["Embed_1"] = {
            "embedding": _np(sd[prefix + "target_embedding.weight"])
        }
    conv1 = port_so2_conv(sd, prefix + "so2_conv_1.", mmax)
    if has_rad:
        conv1["RadialMLP_0"] = port_radial_mlp(
            sd, prefix + "so2_conv_1.rad_func."
        )
    out["so2_conv_1"] = conv1
    out["so2_conv_2"] = port_so2_conv(sd, prefix + "so2_conv_2.", mmax)
    if prefix + "alpha_norm.weight" in sd:
        out["alpha_norm"] = {
            "scale": _np(sd[prefix + "alpha_norm.weight"]),
            "bias": _np(sd[prefix + "alpha_norm.bias"]),
        }
    out["alpha_dot"] = _np(sd[prefix + "alpha_dot"])
    out["proj"] = port_so3_linear(sd, prefix + "proj.")
    if gata:
        out["value_act"] = port_gata_value_activation(
            sd, prefix + "value_act."
        )
    return out


def port_edge_degree_embedding(sd: dict, prefix: str = "",
                               use_atom_edge_embedding: bool = True) -> dict:
    """Reference EdgeDegreeEmbedding params -> flax
    :class:`nn.embedding.EdgeDegreeEmbedding` params (reference
    input_block.py:17-131: source/target nn.Embedding + ``rad_func``
    RadialFunction)."""
    out = {}
    if use_atom_edge_embedding:
        out["Embed_0"] = {
            "embedding": _np(sd[prefix + "source_embedding.weight"])
        }
        out["Embed_1"] = {
            "embedding": _np(sd[prefix + "target_embedding.weight"])
        }
    out["RadialMLP_0"] = port_radial_mlp(sd, prefix + "rad_func.")
    return out


_NORM_CLS = {
    "rms_norm_sh": "EquivariantRMSNormSH",
    "layer_norm_sh": "EquivariantLayerNormSH",
    "layer_norm": "EquivariantLayerNorm",
}


def port_backbone(sd: dict, lmax: int, mmax: int, num_layers: int,
                  gata: bool = False, norm_type: str = "rms_norm_sh",
                  use_atom_edge_embedding: bool = True, **attn_kw) -> dict:
    """Full reference model trunk -> flax ``EquiformerV2Backbone`` params.

    Covers the skeleton every reference model file shares
    (equiformerv2_qm9.py:186-637, equiformerv2_MatPES_GATAV2.py:79-351):
    ``sphere_embedding`` -> ``edge_degree_embedding`` -> ``blocks.{i}`` ->
    final ``norm``, plus the GATA-V2 ``W_erp``/``h_proj`` t_ij projections.
    Per-layer ``block_{i}`` naming (utils/convert.py names them
    ``blocks.i``).
    """
    bb = {
        "sphere_embedding": {"embedding": _np(sd["sphere_embedding.weight"])},
        "edge_degree_embedding": port_edge_degree_embedding(
            sd, "edge_degree_embedding.",
            use_atom_edge_embedding=use_atom_edge_embedding,
        ),
    }
    if gata:
        bb["W_erp"] = _dense(sd, "W_erp")
        bb["h_proj"] = _dense(sd, "h_proj")
    for i in range(num_layers):
        bb[f"block_{i}"] = port_trans_block(
            sd, lmax, mmax, prefix=f"blocks.{i}.", gata=gata,
            norm_type=norm_type,
            use_atom_edge_embedding=use_atom_edge_embedding, **attn_kw,
        )
    bb[f"{_NORM_CLS[norm_type]}_0"] = port_norm(sd, norm_type, "norm.")
    return bb


def port_matpes_model(sd: dict, lmax: int, mmax: int, num_layers: int,
                      gata: bool = True, norm_type: str = "rms_norm_sh",
                      **kw) -> dict:
    """ENTIRE reference MatPES model state_dict -> the port's
    ``models.matpes.EquiformerV2MatPES`` state_dict (reference
    equiformerv2_MatPES_GATAV2.py:79-438: trunk + ``energy_block`` FFN)."""
    return flax_to_state_dict({
        "backbone": port_backbone(
            sd, lmax, mmax, num_layers, gata=gata, norm_type=norm_type, **kw,
        ),
        "energy_block": port_ffn(sd, "energy_block."),
    })


def port_qm9_model(sd: dict, lmax: int, mmax: int, num_layers: int,
                   num_targets: int = 12, norm_type: str = "rms_norm_sh",
                   **kw) -> dict:
    """ENTIRE reference QM9 model state_dict -> the port's
    ``models.qm9.EquiformerV2QM9`` state_dict (reference
    equiformerv2_qm9.py:186-697: trunk + ``output_blocks.{t}`` 12 FFN
    heads, stacked along a leading head axis as the port's model holds
    them)."""
    heads = [
        port_ffn(sd, f"output_blocks.{t}.") for t in range(num_targets)
    ]
    return flax_to_state_dict({
        "backbone": port_backbone(
            sd, lmax, mmax, num_layers, gata=False, norm_type=norm_type, **kw
        ),
        "output_blocks": _stack(heads),
    })


def _stack(trees: list) -> dict:
    """Stack same-shaped nested dicts of arrays along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in sorted(trees[0])}
    return np.stack(trees, axis=0)


def port_trans_block(sd: dict, lmax: int, mmax: int, prefix: str = "",
                     gata: bool = True, norm_type: str = "rms_norm_sh",
                     **attn_kw) -> dict:
    """Reference TransBlockV2 params -> flax :class:`nn.block.TransBlock`
    (GATA fork transformer_block.py:471-680: norm_1 -> htr -> ga -> norm_2
    -> ffn [+ ffn_shortcut])."""
    norm_cls = {
        "rms_norm_sh": "EquivariantRMSNormSH",
        "layer_norm_sh": "EquivariantLayerNormSH",
        "layer_norm": "EquivariantLayerNorm",
    }[norm_type]
    norm_kind = {"rms_norm_sh": "rms_norm_sh",
                 "layer_norm_sh": "layer_norm_sh",
                 "layer_norm": "layer_norm"}[norm_type]
    out = {
        f"{norm_cls}_0": port_norm(sd, norm_kind, prefix + "norm_1."),
        f"{norm_cls}_1": port_norm(sd, norm_kind, prefix + "norm_2."),
        "ga": port_graph_attention(
            sd, lmax, mmax, prefix + "ga.", gata=gata, **attn_kw
        ),
        "ffn": port_ffn(sd, prefix + "ffn."),
    }
    if gata:
        out["htr"] = port_htr(sd, lmax, prefix + "htr.")
    if prefix + "ffn_shortcut.weight" in sd:
        out["ffn_shortcut"] = port_so3_linear(sd, prefix + "ffn_shortcut.")
    return out
