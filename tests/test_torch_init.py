"""The port's ``init_weights`` against the JAX package's initializers.

For every registry preset at a small width (1 layer, 16 channels, 100
elements, so that the embeddings and the radial MLPs hold 1,000 elements
or more), Flax's ``model.init`` and the port's ``init_weights`` draw the
weights from their own seeds; after the name conversion of utils/convert.py
they must have the same leaves, the same constants (zeros, ones, the eSEN
gates' 2.0) exactly, a standard deviation within 10 % of Flax's for every
leaf of 1,000 elements or more, and, where JAX draws from a uniform
distribution, no value beyond its bound.
"""

import math

import jax
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu_torch.models import registry
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import init_weights
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

import torch_variant_helpers as h

WIDTHS = dict(num_layers=1, sphere_channels=16, attn_hidden_channels=16,
              ffn_hidden_channels=32, edge_channels=16, num_rbf=32, attn_alpha_channels=8,
              attn_value_channels=8)


def _cfg(name):
    cfg = {**h.small_cfg(name), **WIDTHS}
    if name != "equiformer_v2_qm9":
        cfg["max_num_elements"] = 100
    return cfg


def _uniform_bound(name: str, w: np.ndarray) -> float | None:
    """The bound of the uniform distribution JAX draws ``name`` from, or
    None where it draws from another."""
    if ".rad.linears." in name and name.endswith(".weight"):
        return 1.0 / math.sqrt(w.shape[-1])                 # fan_in_uniform
    if name.endswith("htr.gamma_w.weight") and "angular" not in name:
        return math.sqrt(6.0 / (w.shape[0] + w.shape[1]))   # xavier_uniform
    if name.endswith("_embedding.weight") and "sphere_embedding" not in name:
        return 1e-3
    if name.endswith("alpha_dot"):
        return 1.0 / math.sqrt(w.shape[-1])
    return None


def _batch(name):
    jb, _ = h.batches(seed=0)
    if name == "equiformer_v2_qm9":
        jb = {k: v for k, v in jb.items() if k not in ("energy", "forces")}
    return jb


@pytest.mark.parametrize("name", registry.list_models())
def test_init_weights_follow_the_jax_initializers(name):
    cfg = _cfg(name)
    jm = h.jregistry.make_model(name, **cfg, **h.JAX_LAYOUT)
    want = {k: v.numpy() for k, v in flax_to_state_dict(
        h.run_jax(jm.init, jax.random.PRNGKey(0), _batch(name))).items()}
    port = init_weights(registry.make_model(name, **cfg), torch.Generator().manual_seed(0))
    got = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    assert got.keys() == want.keys()
    assert registry.count_params(port) == sum(w.size for w in want.values())
    bad = []
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if w.min() == w.max():
            if not (g == w.flat[0]).all():
                bad.append(f"{k}: JAX's constant {w.flat[0]}, the port's values "
                           f"{g.min()}..{g.max()}")
            continue
        if w.size >= 1000 and abs(g.std() / w.std() - 1.0) > 0.1:
            bad.append(f"{k}: std {g.std():.4g}, JAX's {w.std():.4g}")
        bound = _uniform_bound(k, w)
        if bound is not None:
            assert np.abs(w).max() <= bound * (1 + 1e-6), k   # the rule reads JAX right
            if np.abs(g).max() > bound * (1 + 1e-6):
                bad.append(f"{k}: max |w| {np.abs(g).max():.4g} beyond JAX's uniform "
                           f"bound {bound:.4g}")
    assert not bad, "\n".join(bad)
