"""MatPES registry presets (part b of two): the port's energies and forces
against the JAX package's on the CPU.

Each preset is built by both registries' ``make_model`` at a small size
(1 layer, lmax 2 / mmax 1, 8 channels; GATA v1 at lmax = mmax = 2), with
the same random weights (Flax's, converted by utils/convert.py), on three
periodic structures in the fixed-degree layout: energies and forces within
1e-5 relative to the largest value.  The presets of
tests/test_torch_variants_train.py are held there, with a training step.
"""

import pytest

import torch_variant_helpers as h


@pytest.mark.parametrize("name", h.FORWARD_CHECKED[6:])
def test_preset_energies_and_forces_match_jax(name):
    errs = h.energy_forces_errors(name)
    print(name, errs)
    assert all(v <= 1e-5 for v in errs.values()), errs
