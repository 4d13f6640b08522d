"""Model registry: name -> (model class, default overrides).

Port of the JAX package's models/registry.py: one entry per reference model
file (the reference's ``@registry.register_model(...)``), the nine forked
MatPES variants as presets of the unified ``EquiformerV2MatPES``, with the
JAX package's overrides.  ``make_model(name, **kwargs)`` builds a model on
the CPU (move it with ``.to("cuda")``); the variants are reached only this
way, as in the JAX package, whose training CLI selects none.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch.nn as nn

__all__ = ["register_model", "get_model", "make_model", "list_models", "count_params"]

_REGISTRY: Dict[str, Tuple[Callable, dict]] = {}


def register_model(name: str, cls=None, **overrides):
    if cls is None:
        def deco(c):
            _REGISTRY[name] = (c, overrides)
            return c

        return deco
    _REGISTRY[name] = (cls, overrides)
    return cls


def get_model(name: str):
    return _REGISTRY[name]


def make_model(name: str, **kwargs) -> nn.Module:
    cls, overrides = _REGISTRY[name]
    return cls(**{**overrides, **kwargs})


def list_models():
    return sorted(_REGISTRY)


def count_params(model: nn.Module) -> int:
    """Reference ``num_params`` property (equiformerv2_qm9.py:707-709)."""
    return sum(p.numel() for p in model.parameters())


def _populate():
    from .matpes import EquiformerV2MatPES
    from .oc20 import EquiformerV2OC20
    from .qm9 import EquiformerV2QM9

    register_model("equiformer_v2_qm9", EquiformerV2QM9)
    register_model("equiformer_v2_oc20", EquiformerV2OC20)
    # equiformerv2_MatPES.py (baseline, autograd forces + stress)
    register_model("equiformer_v2_matpes", EquiformerV2MatPES, gata=False)
    # equiformerv2_MatPESv2.py (trimmed output dict: the same model)
    register_model("equiformer_v2_matpes_v2", EquiformerV2MatPES, gata=False)
    # equiformerv2_MatPESv2_all2all.py
    register_model("equiformer_v2_matpes_v2_all2all", EquiformerV2MatPES, gata=False,
                   global_attn="scalar")
    # equiformerv2_MatPES_GATA.py (v1, Gotennet_inspired fork): its config
    # (config_cosinelearningGATA.py:109-110) runs lmax = mmax = 4 with
    # attn_hidden_channels == sphere_channels, both required by the fork
    register_model("equiformer_v2_matpes_gata", EquiformerV2MatPES, gata=False,
                   gata_v1=True, mmax=4)
    # equiformerv2_MatPES_GATAV2.py
    register_model("equiformer_v2_matpes_gatav2", EquiformerV2MatPES, gata=True)
    # ..._no_normalize_attn_output.py
    register_model("equiformer_v2_matpes_gatav2_no_attn_norm", EquiformerV2MatPES,
                   gata=True, normalize_attn_output=False)
    # ..._phi_at_every_iteration_like_gata.py
    register_model("equiformer_v2_matpes_gatav2_phi_every_layer", EquiformerV2MatPES,
                   gata=True, use_phi_every_layer=True)
    # ..._all_to_all_phi_at_every_iteration_like_gata.py
    register_model("equiformer_v2_matpes_gatav2_all2all_phi", EquiformerV2MatPES,
                   gata=True, use_phi_every_layer=True, global_attn="scalar")
    # ..._GLOBALALLATTENTION_phi_at_every_iteration_like_gata.py
    register_model("equiformer_v2_matpes_gatav2_globalattn_phi", EquiformerV2MatPES,
                   gata=True, use_phi_every_layer=True, global_attn="full_equivariant")
    # ..._GLOBALALLATTENTION_HTR_phi..._with_DISTANCE.py
    register_model("equiformer_v2_matpes_gatav2_htr_global_distance", EquiformerV2MatPES,
                   gata=True, use_phi_every_layer=True, global_attn="htr_rope")
    # MoE / dual-stream experimental forks
    register_model("equiformer_v2_matpes_gatav2_moe", EquiformerV2MatPES, gata=True,
                   ffn_variant="moe")
    register_model("equiformer_v2_matpes_gatav2_moe_breaking", EquiformerV2MatPES,
                   gata=True, ffn_variant="moe_breaking")
    register_model("equiformer_v2_matpes_gatav2_dual_stream", EquiformerV2MatPES,
                   gata=True, dual_stream=True, ffn_variant="tensor_product")
    # GATA_and_all2all_escninsipred_envelope_and_simple_gating fork: GATA
    # attention + the eSEN gated-SH FFN (no S2 grid)
    register_model("equiformer_v2_matpes_gata_esen_ffn", EquiformerV2MatPES, gata=True,
                   ffn_variant="esen")


_populate()
