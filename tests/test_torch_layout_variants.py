"""The MatPES variants in the ragged and graph-uniform layouts: the port
against the JAX package on the CPU.

The dual-stream, MoE and global-attention presets of the model registry at
the small widths of ``torch_variant_helpers`` (1 layer, 8 channels, lmax 2
/ mmax 1), each in the ragged and the uniform layout, on three labelled
crystals made by numpy from a seed: energies 1e-5 relative, forces and
per-graph stress 1e-4 of their largest entry, the force-training loss with
stress 1e-5 and its gradients (a grad-of-grad) 1e-4 relative L2, against
JAX on the same batch (``test_torch_layouts._matpes_errors``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.models import registry as jregistry
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    matpes_energy_forces_stress_pergraph as jax_pergraph,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models import registry
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    matpes_energy_forces,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import matpes_loss
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)
from test_torch_layouts import LIMITS, W_STRESS, _collate, _samples

VARIANTS = ("equiformer_v2_matpes_gatav2_dual_stream", "equiformer_v2_matpes_gatav2_moe",
            "equiformer_v2_matpes_gatav2_htr_global_distance")


@pytest.mark.parametrize("layout", ["ragged", "uniform"])
@pytest.mark.parametrize("name", VARIANTS, ids=["dual_stream", "moe", "global_attn"])
def test_variant_matches_jax(name, layout):
    pb = _collate(tgraph, _samples(7), layout)
    jb, tb = {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")
    fields = dict(uniform_blocks=layout == "uniform")
    jm = jregistry.make_model(name, **{**V.small_cfg(name), **fields, "wigner_rep": "dense",
                                       "remat": False})
    params = V.random_flax_params(jm, jb, 8)

    def loss_fn(p):
        outs = jax_pergraph(jm, p, jb)
        return jtrainer.matpes_loss(outs, jb, 1.0, 1.0, W_STRESS)[0], outs

    with flags.override(wigner="dense"):
        (loss_j, outs_j), grads_j = V.run_jax(jax.value_and_grad(loss_fn, has_aux=True), params)
    grads_j = flax_to_state_dict(grads_j)
    model = registry.make_model(name, **{**V.small_cfg(name), **fields})
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    outs = matpes_energy_forces(model, tb, create_graph=True, regress_stress=True)
    loss, _ = matpes_loss(outs, tb, 1.0, 1.0, W_STRESS)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach()
             for n, p in model.named_parameters()}
    assert grads.keys() == grads_j.keys()
    m = pb.node_mask
    errs = {"energy": V.rel(outs["energy"].detach().numpy(), outs_j["energy"]),
            "forces": V.rel(outs["forces"].detach().numpy()[m], np.asarray(outs_j["forces"])[m]),
            "stress": V.rel(outs["stress"].detach().numpy(), outs_j["stress"]),
            "loss": abs(float(loss.detach()) - float(loss_j)) / abs(float(loss_j)),
            "gradients": V.rel_l2(grads, grads_j)}
    print(f"{name} {layout}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert all(errs[k] <= LIMITS[k] for k in LIMITS), errs
