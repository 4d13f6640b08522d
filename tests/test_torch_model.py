"""The serving slice end to end: the port's Predictor against the JAX model.

Small configuration (2 layers, lmax 2 / mmax 1, 16 channels).  Random Flax
params, made by numpy from a seed, move to the port through
utils/convert.py; the same structures go through the JAX package's
``matpes_energy_forces_stress`` (dense Wigner) and through the port's
``Predictor`` on the CPU, which batches them in the ragged layout.  The JAX
side runs the port's fixed-degree collate of the structures, or the JAX
package's own packed batch of them (the layout changes no parameter and no
result).  Energies are
held to a relative error of 1e-5 and forces to 1e-4 max|F|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
)
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import (
    fixed_degree_pads,
)

CFG = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=2, mmax=1, grid_resolution=None, edge_channels=16, num_rbf=32,
           cutoff=5.0)
CUTOFF, MAX_NEIGHBORS = 5.0, 8


def _structures(seed=0, sizes=(5, 7, 6)):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
        pos = (rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32)
        z = rng.integers(1, 80, size=n).astype(np.int32)
        out.append(dict(atomic_numbers=z, positions=pos,
                        cell=None if i == 2 else cell))   # one molecule, no PBC
    return out


def _random_flax_params(jm, batch, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _fixed_degree_batch(structs):
    """The port's fixed-degree collate of the structures."""
    samples = [tgraph.GraphSample(s["atomic_numbers"], s["positions"], s["cell"],
                                  s["cell"] is not None) for s in structs]
    n_pad, e_pad = fixed_degree_pads([len(s["atomic_numbers"]) for s in structs],
                                     MAX_NEIGHBORS)
    return tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, fixed_degree=True)


def _jax_packed_batch(structs):
    """The JAX package's own packed collate of the structures."""
    samples = [jgraph.GraphSample(s["atomic_numbers"], s["positions"], s["cell"],
                                  s["cell"] is not None) for s in structs]
    return jgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, 32, 512)


@pytest.mark.parametrize(
    "jax_layout,s2_fused",
    [("fixed_degree", "auto"), ("packed", "auto"), ("fixed_degree", "force")],
    ids=["fixed_degree", "jax_packed", "fixed_degree-jax_s2_kernel"],
)
def test_predictor_matches_jax(monkeypatch, jax_layout, s2_fused):
    """s2_fused='force' runs the JAX package's S2 kernels (interpret mode)."""
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    structs = _structures()
    port = EquiformerV2MatPES(**CFG)
    fixed = jax_layout == "fixed_degree"
    pb = _fixed_degree_batch(structs) if fixed else _jax_packed_batch(structs)
    batch = {k: jnp.asarray(v) for k, v in pb.asdict().items()}
    jm = JaxMatPES(**CFG, fixed_degree=fixed, uniform_blocks=fixed,
                   wigner_rep="dense", remat=False, alpha_drop=0.0, drop_path_rate=0.0)
    params = _random_flax_params(jm, batch)
    with flags.override(wigner="dense", s2_fused=s2_fused):
        ref = jax.jit(lambda p, b: matpes_energy_forces_stress(jm, p, b))(params, batch)

    pred = Predictor(port, flax_to_state_dict(params), CUTOFF, MAX_NEIGHBORS, device="cpu")
    out = pred.predict_batch(structs)
    natoms = np.asarray(pb.natoms)
    e_ref = np.asarray(ref["energy"][:, 0]) * natoms
    np.testing.assert_allclose(out["energy"], e_ref, rtol=1e-5)
    np.testing.assert_allclose(out["energy_per_atom"], np.asarray(ref["energy"][:, 0]),
                               rtol=1e-5)
    f_ref = np.asarray(ref["forces"])[np.flatnonzero(pb.node_mask)]
    f_out = np.concatenate(out["forces"])
    assert [f.shape[0] for f in out["forces"]] == [len(s["atomic_numbers"]) for s in structs]
    np.testing.assert_allclose(f_out, f_ref, rtol=0, atol=1e-4 * np.abs(f_ref).max())


def test_scan_layers_params_convert_like_unrolled():
    """scan_layers=True params (stacked on a layer axis) give the same
    state_dict as the unrolled model's, and it loads strictly."""
    structs = _structures(sizes=(4, 5))
    port = EquiformerV2MatPES(**CFG)
    pb = _fixed_degree_batch(structs)
    batch = {k: jnp.asarray(v) for k, v in pb.asdict().items()}
    kw = dict(fixed_degree=True, uniform_blocks=True, wigner_rep="dense", remat=False)
    unrolled = _random_flax_params(JaxMatPES(**CFG, **kw), batch, seed=1)
    scanned_shapes = jax.eval_shape(
        lambda: JaxMatPES(**CFG, **kw, scan_layers=True).init(jax.random.PRNGKey(0), batch)
    )
    bb = dict(unrolled["params"]["backbone"])
    layers = [bb.pop(f"block_{i}") for i in range(CFG["num_layers"])]
    bb["blocks"] = {"block": jax.tree_util.tree_map(lambda *a: np.stack(a), *layers)}
    scanned = {"params": {**unrolled["params"], "backbone": bb}}
    assert (jax.tree_util.tree_structure(scanned_shapes)
            == jax.tree_util.tree_structure(scanned))
    sd_u, sd_s = flax_to_state_dict(unrolled), flax_to_state_dict(scanned)
    assert sd_u.keys() == sd_s.keys() == port.state_dict().keys()
    for k in sd_u:
        torch.testing.assert_close(sd_u[k], sd_s[k], rtol=0, atol=0)
    port.load_state_dict(sd_s, strict=True)


def test_collate_copy_matches_jax(monkeypatch):
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    structs = _structures(seed=3)
    samples_t = [tgraph.GraphSample(s["atomic_numbers"], s["positions"], s["cell"],
                                    s["cell"] is not None) for s in structs]
    samples_j = [jgraph.GraphSample(s["atomic_numbers"], s["positions"], s["cell"],
                                    s["cell"] is not None) for s in structs]
    n_pad, e_pad = 24, 24 * MAX_NEIGHBORS
    a = tgraph.collate(samples_t, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, fixed_degree=True)
    b = jgraph.collate(samples_j, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, fixed_degree=True)
    assert (a.overflow_atoms, a.overflow_edges) == (b.overflow_atoms, b.overflow_edges)
    a, b = a.asdict(), b.asdict()
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pad_sizes():
    # the fixed-degree pads: the ragged request's n_pad bucket split evenly
    # over the graphs, k slots per node
    assert fixed_degree_pads([30] * 16, 20) == (496, 9920)
    # ... raised to hold the largest graph
    assert fixed_degree_pads([3, 40], 7) == (80, 560)


def test_random_init_serves_finite_outputs_and_predict_agrees():
    port = init_weights(EquiformerV2MatPES(**CFG), torch.Generator().manual_seed(0))
    pred = Predictor(port, port.state_dict(), CUTOFF, None, device="cpu")
    structs = _structures(seed=4)
    out = pred.predict_batch(structs)
    assert np.isfinite(out["energy"]).all()
    assert all(np.isfinite(f).all() for f in out["forces"])
    one = pred.predict(structs[0]["atomic_numbers"], structs[0]["positions"],
                       structs[0]["cell"])
    np.testing.assert_allclose(one["energy"], out["energy"][0], rtol=1e-5)
    np.testing.assert_allclose(one["forces"], out["forces"][0], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(one["forces"]).max()))
