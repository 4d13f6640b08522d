"""Force training of the headline global-attention preset, GATA v1 and the
MoE: the port against the JAX package on the CPU, and the MoE's routing
entropy.

One float32 step at a small size (1 layer, lmax 2 / mmax 1, 8 channels;
GATA v1 at lmax = mmax = 2) from the same converted weights: the loss
(L1 energy + L1 forces, the trainer's) within 1e-5 relative, its
parameter gradients (a grad-of-grad through the force derivative) within
1e-5 relative L2, and the forward's energies and forces within 1e-5
relative.  The routing entropy the port keeps after a forward equals the
value the JAX model sows, to 1e-6 relative.
"""

import numpy as np
import pytest

from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    matpes_energy_forces,
    routing_entropies,
)

import torch_variant_helpers as h


@pytest.mark.parametrize("name", h.TRAIN_CHECKED)
def test_training_step_matches_jax(name):
    errs = h.train_step_errors(name)
    print(name, errs)
    assert all(v <= 1e-5 for v in errs.values()), errs


def test_routing_entropy_matches_the_sown_value():
    name = "equiformer_v2_matpes_gatav2_moe_breaking"
    jb, tb = h.batches(seed=7)
    jm = h.jax_model(name)
    params = h.random_flax_params(jm, jb, 8)
    with flags.override(wigner="dense"):
        _, state = h.run_jax(lambda p, b: jm.apply(p, b, mutable=["intermediates"]), params, jb)
    want = [float(state["intermediates"]["backbone"]["block_0"]["routing_entropy"][0])]
    model = h.port_model(name, params)
    matpes_energy_forces(model, tb)
    got = [float(e) for e in routing_entropies(model)]
    print(name, got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6)
