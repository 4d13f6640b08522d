"""Per-graph stress and the GATA-V2 options: the port against the JAX package.

Small configuration (2 layers, lmax 2 / mmax 1, 16 channels, as
tests/test_torch_train.py) on a fixed-degree batch of three periodic
crystals with stress labels.  Random Flax params, made by numpy from a
seed, move to the port through utils/convert.py; the JAX side runs on the
dense Wigner representation, as its own tests run it on the CPU.

Limits, relative to max |JAX| (or |JAX| for a scalar): float32 energy,
forces and stress 1e-5; the float32 training step with ``w_stress = 0.1``
loss 1e-6 and gradients 1e-5 relative L2; the bfloat16 step loss 2e-2 and
gradients 5e-2 (bf16 rounds at other places in the two frameworks).  The
options ``normalize_attn_output=False`` and ``use_phi_every_layer=True``:
energies and forces 1e-5.  ``pytest -s`` prints the measured errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
    matpes_energy_forces_stress_pergraph as jax_pergraph,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import schedules as jsched
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
    matpes_energy_forces,
    matpes_energy_forces_stress_pergraph,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import (
    schedules as tsched,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    cast_params,
    create_train_state,
    make_matpes_train_step,
    matpes_loss,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

CFG = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=2, mmax=1, grid_resolution=None, edge_channels=16, num_rbf=32,
           max_num_elements=20, cutoff=5.0)
CUTOFF, MAX_NEIGHBORS, W_STRESS = 5.0, 8, 0.1


def _crystal(rng, n):
    cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
    return tgraph.GraphSample(
        atomic_numbers=rng.integers(1, 15, size=n).astype(np.int32),
        pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32), cell=cell, pbc=True,
        energy=float(rng.normal()), forces=rng.normal(size=(n, 3)).astype(np.float32),
        stress=(rng.normal(size=6) * 0.05).astype(np.float32))


def _collate(samples, n_slot=8):
    pb = tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, len(samples) * n_slot,
                        len(samples) * n_slot * MAX_NEIGHBORS, fixed_degree=True)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return pb


def _both(pb):
    return {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


def _samples(seed=0, sizes=(4, 6, 5)):
    rng = np.random.default_rng(seed)
    return [_crystal(rng, n) for n in sizes]


def _jax_model(compute_dtype="float32", **kw):
    return JaxMatPES(**CFG, fixed_degree=True, uniform_blocks=True, wigner_rep="dense",
                     remat=False, alpha_drop=0.0, drop_path_rate=0.0,
                     compute_dtype=compute_dtype, **kw)


def _random_flax_params(jm, batch, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _port_model(params, compute_dtype=torch.float32, **kw):
    model = EquiformerV2MatPES(**CFG, alpha_drop=0.0, drop_path_rate=0.0,
                               compute_dtype=compute_dtype, **kw)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("gata", [True, False], ids=["gata", "baseline"])
def test_pergraph_stress_matches_jax(gata):
    jb, tb = _both(_collate(_samples()))
    jm = _jax_model(gata=gata)
    params = _random_flax_params(jm, jb, seed=1)
    with flags.override(wigner="dense"):
        want = jax.jit(lambda p, b: jax_pergraph(jm, p, b))(params, jb)
    model = _port_model(params, gata=gata).eval()
    got = matpes_energy_forces_stress_pergraph(model, tb)
    routed = matpes_energy_forces(model, tb, regress_stress=True)
    assert got["stress"].shape == (3, 6)
    errs = {k: _rel(got[k].numpy(), want[k]) for k in ("energy", "forces", "stress")}
    print(f"per-graph stress, gata={gata}: " + ", ".join(f"{k} {v:.2e}"
                                                       for k, v in errs.items()))
    assert all(v <= 1e-5 for v in errs.values()), errs
    for k in ("energy", "forces", "stress"):
        torch.testing.assert_close(routed[k], got[k], rtol=0, atol=0)


def test_stress_of_four_graphs_equals_each_alone():
    """The counterpart of tests/test_forces.py's batch-independence test:
    one strain per graph, so graph i's stress in a batch of four equals its
    stress computed alone."""
    samples = _samples(seed=7, sizes=(3, 4, 3, 4))
    model = init_weights(EquiformerV2MatPES(**CFG, gata=False, alpha_drop=0.0,
                                            drop_path_rate=0.0),
                         torch.Generator().manual_seed(0)).eval()
    s4 = matpes_energy_forces_stress_pergraph(
        model, tgraph.as_tensors(_collate(samples), "cpu"))["stress"]
    scale = float(s4.abs().max())
    for i, s in enumerate(samples):
        s1 = matpes_energy_forces_stress_pergraph(
            model, tgraph.as_tensors(_collate([s]), "cpu"))["stress"][0]
        torch.testing.assert_close(s4[i], s1, rtol=0, atol=1e-5 * max(scale, 1.0))


def test_stress_matches_finite_difference():
    """Voigt stress against central differences of the energy under a
    symmetric strain of the positions and the cell (tests/test_forces.py's
    check and limits)."""
    (s,) = _samples(seed=1, sizes=(4,))
    pb = _collate([s])
    tb = tgraph.as_tensors(pb, "cpu")
    model = init_weights(EquiformerV2MatPES(**CFG, gata=False, alpha_drop=0.0,
                                            drop_path_rate=0.0),
                         torch.Generator().manual_seed(1)).eval()
    stress = matpes_energy_forces_stress_pergraph(model, tb)["stress"][0].numpy()
    vol = abs(np.linalg.det(pb.cell[0].astype(np.float64)))

    def energy_strained(strain):
        defo = torch.eye(3) + torch.as_tensor(strain)
        b = dict(tb, strained_cell=tb["cell"] @ defo)
        with torch.no_grad():
            return float(model(b, pos=tb["pos"] @ defo)["energy_total"].sum())

    eps = 2e-3
    for vi, (a, c) in enumerate([(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]):
        st = np.zeros((3, 3), np.float32)
        st[a, c] += eps / 2
        st[c, a] += eps / 2
        fd = (energy_strained(st) - energy_strained(-st)) / (2 * eps) / vol
        assert abs(fd - stress[vi]) < 5e-3 + 0.05 * abs(fd), (vi, fd, stress[vi])


def _jax_loss_fn(jm, batch, mixed):
    """make_matpes_train_step's loss with w_stress > 0 (train/trainer.py)."""
    def loss_fn(p):
        if mixed:
            p = jtrainer.cast_params(p, jnp.bfloat16)
        outs = jax_pergraph(jm, p, batch, rngs={"dropout": jax.random.PRNGKey(0)},
                            deterministic=False)
        return jtrainer.matpes_loss(outs, batch, 1.0, 1.0, W_STRESS)

    return loss_fn


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_stress_train_step_matches_jax(mixed):
    """One training step with ``w_stress = 0.1``: the port's
    make_matpes_train_step against the JAX package's (loss and metrics),
    and the gradients of its loss (a grad-of-grad through both the force
    and the strain derivative) against JAX's."""
    jb, tb = _both(_collate(_samples(seed=2)))
    jm = _jax_model("bfloat16" if mixed else "float32", gata=False)
    params = _random_flax_params(jm, jb, seed=3)
    with flags.override(wigner="dense"):
        (loss_j, met_j), grads_j = jax.jit(jax.value_and_grad(
            _jax_loss_fn(jm, jb, mixed), has_aux=True))(params)
        if not mixed:
            tx = jtrainer.make_optimizer(jsched.warmup_cosine(1e-3, 2, 10), 1e-3, 1.0)
            _, step_met = jax.jit(jtrainer.make_matpes_train_step(jm, tx, 1.0, 1.0, W_STRESS))(
                jtrainer.create_train_state(params, tx), jb, jax.random.PRNGKey(0))
            np.testing.assert_allclose(float(step_met["loss"]), float(loss_j), rtol=1e-7)
    grads_j = flax_to_state_dict(grads_j)

    cdt = torch.bfloat16 if mixed else torch.float32
    model = _port_model(params, cdt, gata=False)
    model.zero_grad(set_to_none=True)
    outs = matpes_energy_forces(model, tb, create_graph=True, regress_stress=True,
                                params=cast_params(model, cdt) if mixed else None)
    loss, met = matpes_loss(outs, tb, 1.0, 1.0, W_STRESS)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    assert grads.keys() == grads_j.keys()
    rtol_loss, tol_grad = (2e-2, 5e-2) if mixed else (1e-6, 1e-5)
    loss_err = abs(float(loss.detach()) - float(loss_j)) / abs(float(loss_j))
    grad_err = _rel_l2(grads, grads_j)
    print(f"stress step {'bf16' if mixed else 'f32'}: loss rel err {loss_err:.2e}, "
          f"stress_l1 {float(met['stress_l1'].detach()):.4e} (JAX {float(met_j['stress_l1']):.4e}), "
          f"gradient rel L2 err {grad_err:.2e}")
    assert loss_err <= rtol_loss and grad_err <= tol_grad, (loss_err, grad_err)
    for k in ("energy_l1", "force_l1", "stress_l1"):
        np.testing.assert_allclose(float(met[k].detach()), float(met_j[k]), rtol=rtol_loss,
                                   err_msg=k)

    # the port's step: the same loss, the update applied
    model = _port_model(params, cdt, gata=False)
    state = create_train_state(model, GuardedAdamW(
        model.named_parameters(), tsched.warmup_cosine(1e-3, 2, 10), 1e-3, 1.0))
    step_loss, m = make_matpes_train_step(state, w_stress=W_STRESS)(tb)
    assert m["accepted"] and torch.isfinite(m["stress_l1"])
    np.testing.assert_allclose(float(step_loss), float(loss.detach()), rtol=1e-6)
    if not mixed:
        for k in ("loss", "energy_l1", "force_l1", "stress_l1"):
            np.testing.assert_allclose(float(m[k]), float(step_met[k]), rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("option", [dict(normalize_attn_output=False),
                                    dict(use_phi_every_layer=True)],
                         ids=["no-attn-norm", "phi-every-layer"])
def test_gata_options_match_jax(option):
    """Energies and forces of the two GATA-V2 options; ``phi_proj`` (the
    one parameter they add) is converted in every layer."""
    jb, tb = _both(_collate(_samples(seed=4)))
    jm = _jax_model(**option)
    params = _random_flax_params(jm, jb, seed=5)
    with flags.override(wigner="dense"):
        want = jax.jit(lambda p, b: matpes_energy_forces_stress(jm, p, b))(params, jb)
    sd = flax_to_state_dict(params)
    phi = sorted(k for k in sd if ".phi_proj." in k)
    if option.get("use_phi_every_layer"):
        assert phi == [f"backbone.blocks.{i}.ga.value_act.phi_proj.{leaf}"
                       for i in range(CFG["num_layers"]) for leaf in ("bias", "weight")]
    else:
        assert not phi
    model = _port_model(params, **option).eval()
    got = matpes_energy_forces(model, tb)
    errs = {k: _rel(got[k].numpy(), want[k]) for k in ("energy", "forces")}
    print(f"{option}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert all(v <= 1e-5 for v in errs.values()), errs
