"""Flax params (nested dict of numpy arrays) -> the port's ``state_dict``.

The params of the JAX package's ``EquiformerV2MatPES`` (every registry
variant: GATA-V2, GATA v1, the baseline, the global-attention stage, the
MoE, dual-stream and eSEN FFNs), ``EquiformerV2QM9`` (baseline backbone +
``output_blocks``) and ``EquiformerV2OC20`` (baseline backbone +
``energy_block`` + ``force_block``, a ``FeedForward`` and a
``GraphAttention`` at the top level) map one to one onto the port's
modules:

* ``Dense`` ``kernel`` [in, out] -> ``nn.Linear.weight`` [out, in] (the
  stacked ``kernel`` [T, in, out] of the QM9 heads and of the MoE experts
  ``experts_eq`` / ``experts_ne`` -> [T, out, in]: the last two axes swap,
  the head / expert order stays);
  ``Embed`` ``embedding`` -> ``nn.Embedding.weight``; ``LayerNorm``
  ``scale`` -> ``weight``; every other leaf (SO3/SO2 weights, norms,
  ``alpha_dot``) keeps its name and layout;
* Flax's automatic names become the port's: ``Embed_0`` / ``Embed_1`` ->
  ``src_embedding`` / ``dst_embedding``, ``RadialMLP_0`` -> ``rad``,
  ``Dense_i`` / ``LayerNorm_i`` -> ``linears.i`` / ``norms.i`` (the
  ``LayerNorm_0`` of an ``EquivariantLayerNormSH`` -> ``l0_norm``), and
  the ``EquivariantRMSNormSH_*`` / ``EquivariantLayerNormSH_*`` /
  ``EquivariantLayerNorm_*`` norms -> ``attn_norm`` / ``ffn_norm`` inside a
  block, ``norm`` after the stack;
* ``block_i`` -> ``blocks.i``; with ``scan_layers=True`` the stacked
  ``blocks/block`` params (a leading layer axis) are split into
  ``blocks.0 .. blocks.L-1``;
* every other module is named alike on both sides and needs no rule of
  its own: ``global_attn/*`` (with ``rope/rope_freqs``), the MoE's
  ``router_*``, the dual stream's ``a_h_proj`` / ``a_W_erp`` /
  ``angular_htr`` and ``TensorProductFFN``, the eSEN ``gate_proj_*``, the
  ``grid_mlp_*`` and ``value_act/phi_proj``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["flax_to_state_dict", "flatten", "port_name"]


def flatten(tree, prefix=()):
    """Nested dict -> {path tuple: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _rename(path: tuple) -> tuple:
    out = []
    for i, seg in enumerate(path):
        in_block = i > 0 and re.fullmatch(r"blocks\.\d+|block_\d+", path[i - 1])
        if seg == "Embed_0":
            seg = "src_embedding"
        elif seg == "Embed_1":
            seg = "dst_embedding"
        elif seg == "RadialMLP_0":
            seg = "rad"
        elif m := re.fullmatch(r"Dense_(\d+)", seg):
            seg = f"linears.{m.group(1)}"
        elif m := re.fullmatch(r"LayerNorm_(\d+)", seg):
            in_sh_norm = i > 0 and re.fullmatch(r"EquivariantLayerNormSH_\d+", path[i - 1])
            seg = "l0_norm" if in_sh_norm else f"norms.{m.group(1)}"
        elif m := re.fullmatch(r"Equivariant(?:RMSNormSH|LayerNormSH|LayerNorm)_(\d+)", seg):
            seg = ("attn_norm", "ffn_norm")[int(m.group(1))] if in_block else "norm"
        elif m := re.fullmatch(r"block_(\d+)", seg):
            seg = f"blocks.{m.group(1)}"
        out.append(seg)
    return tuple(out)


def _leaf(path: tuple, value: np.ndarray | None):
    *mods, leaf = path
    if leaf == "kernel":
        return mods + ["weight"], None if value is None else np.swapaxes(value, -1, -2)
    if leaf in ("embedding", "scale"):
        return mods + ["weight"], value
    return mods + [leaf], value


def port_name(path: tuple) -> str:
    """The port's parameter name of the unrolled Flax param at ``path``."""
    mods, _ = _leaf(_rename(path), None)
    return ".".join(mods)


def flax_to_state_dict(params) -> dict[str, torch.Tensor]:
    """Convert ``{'params': ...}`` or the bare params tree of the JAX
    package's ``EquiformerV2MatPES``, ``EquiformerV2QM9`` or
    ``EquiformerV2OC20`` into the port's ``state_dict``."""
    tree = params.get("params", params)
    flat = flatten(tree)
    expanded = {}
    for path, value in flat.items():
        if len(path) > 2 and path[1:3] == ("blocks", "block"):
            # scan_layers=True: split the leading layer axis
            for i in range(value.shape[0]):
                expanded[(path[0], f"blocks.{i}") + path[3:]] = value[i]
        else:
            expanded[path] = value
    sd = {}
    for path, value in expanded.items():
        mods, v = _leaf(_rename(path), value)
        # a copy: arrays from JAX are read-only
        sd[".".join(mods)] = torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
    return sd
