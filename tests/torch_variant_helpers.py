"""Shared inputs of the tests that hold the port's MatPES variants against
the JAX package's (tests/test_torch_variants_*.py, tests/test_torch_init.py).

Every registry entry is built at a small size (1 layer, lmax 2 / mmax 1, 8
channels; GATA v1 at lmax = mmax = 2) with dropouts 0.  Inputs are made by
numpy from a seed and batched by the port's fixed-degree collate, which the
JAX model runs too (``fixed_degree=True``: the layout changes no parameter).
Random Flax params, also made by numpy from a seed, move to the port through
utils/convert.py.  The JAX side runs the dense Wigner representation, as
its own tests run it on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.models import registry as jregistry
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    matpes_energy_forces_stress,
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

SMALL = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
             attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
             lmax=2, mmax=1, grid_resolution=None, edge_channels=8, num_rbf=16,
             max_num_elements=20, cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
CUTOFF, MAX_NEIGHBORS = 5.0, 6
MATPES = [n for n in registry.list_models() if "matpes" in n]
# the presets whose force-training step tests/test_torch_variants_train.py
# holds (with its energies and forces); the others' energies and forces
# are held in tests/test_torch_variants_models_{a,b}.py
TRAIN_CHECKED = ("equiformer_v2_matpes_gatav2_htr_global_distance",
                 "equiformer_v2_matpes_gata", "equiformer_v2_matpes_gatav2_moe")
FORWARD_CHECKED = [n for n in MATPES if n not in TRAIN_CHECKED]
# the JAX model fields that choose its layout and compile path
JAX_LAYOUT = dict(fixed_degree=True, uniform_blocks=True, wigner_rep="dense", remat=False)
# XLA's CPU backend at its lowest optimization level: these programs run
# once at a small size, so compiling them is most of their time
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def run_jax(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with ``FAST_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)(*args)


def small_cfg(name: str) -> dict:
    """The small widths for ``name`` (GATA v1 runs at lmax = mmax)."""
    cfg = dict(SMALL)
    if name == "equiformer_v2_matpes_gata":
        cfg["mmax"] = cfg["lmax"]
    if name == "equiformer_v2_qm9":
        cfg = {k: v for k, v in cfg.items() if k not in ("max_num_elements",)}
        cfg["num_targets"] = 3
    return cfg


def crystals(seed=0, sizes=(4, 6, 5), labels=True):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        out.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 10, size=n).astype(np.int32),
            pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32), cell=cell,
            pbc=True, energy=float(rng.normal()) if labels else None,
            forces=rng.normal(size=(n, 3)).astype(np.float32) if labels else None))
    return out


def batches(seed=0, sizes=(4, 6, 5), n_slot=8):
    """(JAX batch, port batch) of the same fixed-degree collate."""
    samples = crystals(seed, sizes)
    pb = tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, len(samples) * n_slot,
                        len(samples) * n_slot * MAX_NEIGHBORS, fixed_degree=True)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


def jax_model(name: str, **kw):
    return jregistry.make_model(name, **{**small_cfg(name), **JAX_LAYOUT, **kw})


def random_flax_params(jm, batch, seed=0):
    """Every leaf ~ normal / sqrt(fan-in) from numpy (norm scales and
    biases too, so that each leaf matters)."""
    return random_like_tree(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch)), seed)


def port_model(name: str, params, **kw):
    model = registry.make_model(name, **{**small_cfg(name), **kw})
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model.eval()


def rel(got, want) -> float:
    """max |got - want| / max |want| (absolute where want is all zeros)."""
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    return err / max(float(np.abs(want).max()), 1e-30) if want.any() else err


def rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


def energy_forces_errors(name: str, seed: int = 0, jax_kw: dict | None = None) -> dict:
    """Relative errors of the port's energies and forces against the JAX
    model's, from the same converted weights; ``jax_kw``: model fields
    given to both."""
    jax_kw = jax_kw or {}
    jb, tb = batches(seed)
    jm = jax_model(name, **jax_kw)
    params = random_flax_params(jm, jb, seed + 1)
    with flags.override(wigner="dense"):
        want = run_jax(lambda p, b: matpes_energy_forces_stress(jm, p, b), params, jb)
    got = matpes_energy_forces(port_model(name, params, **jax_kw), tb)
    return {k: rel(got[k].numpy(), want[k]) for k in ("energy", "forces")}


def train_step_errors(name: str, seed: int = 0) -> dict:
    """One float32 force-training loss and its parameter gradients (a
    grad-of-grad through the force derivative), with the energies and
    forces of its forward: the port against JAX."""
    jb, tb = batches(seed)
    jm = jax_model(name)
    params = random_flax_params(jm, jb, seed + 1)

    def loss_fn(p):
        outs = matpes_energy_forces_stress(jm, p, jb)
        return jtrainer.matpes_loss(outs, jb, 1.0, 1.0)[0], outs

    with flags.override(wigner="dense"):
        (loss_j, outs_j), grads_j = run_jax(jax.value_and_grad(loss_fn, has_aux=True), params)
    grads_j = flax_to_state_dict(grads_j)
    model = port_model(name, params)
    outs = matpes_energy_forces(model, tb, create_graph=True)
    loss, _ = matpes_loss(outs, tb, 1.0, 1.0)
    loss.backward()
    # unused parameters (conv 1's m > 0 weights on the GATA paths) get no
    # gradient in the port and zeros in JAX
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
             for n, p in model.named_parameters()}
    assert grads.keys() == grads_j.keys()
    return {"energy": rel(outs["energy"].detach().numpy(), outs_j["energy"]),
            "forces": rel(outs["forces"].detach().numpy(), outs_j["forces"]),
            "loss": abs(float(loss.detach()) - float(loss_j)) / abs(float(loss_j)),
            "gradients": rel_l2(grads, grads_j)}


def random_like_tree(tree, seed=0):
    """numpy normal / sqrt(fan-in) for every leaf of a params tree."""
    rng = np.random.default_rng(seed)

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, tree)


def module_errors(jfn, params, tmod, tfn, inputs, seed=0) -> dict:
    """One module alone, the port against JAX on the same inputs and
    converted params: the output, the gradients of <output, ct> (ct a random
    cotangent) by every float input and by every parameter.

    ``jfn(params, *inputs)`` runs the Flax module, ``tfn(*inputs)`` the
    port's ``tmod`` (None for a function without parameters, with
    ``params`` {}); ``inputs``: float32 numpy arrays.
    """
    tmod = tmod if tmod is not None else torch.nn.Module()
    tmod.load_state_dict(flax_to_state_dict(params), strict=True)
    args = [jnp.asarray(a) for a in inputs]
    shape = jax.eval_shape(jfn, params, *args).shape
    ct = np.random.default_rng(seed).normal(size=shape).astype(np.float32)

    def value_and_vjp(p, ct, *a):
        out, vjp = jax.vjp(jfn, p, *a)
        return out, vjp(ct)

    out_j, (g_params, *g_in) = run_jax(value_and_vjp, params, jnp.asarray(ct), *args)
    xs = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = tfn(*xs)
    (out * torch.as_tensor(ct)).sum().backward()
    want = flax_to_state_dict(g_params)
    got = {n: torch.zeros_like(p) if p.grad is None else p.grad
           for n, p in tmod.named_parameters()}
    assert got.keys() == want.keys()
    errs = {"output": rel(out.detach().numpy(), out_j),
            "inputs": max(rel(np.zeros(x.shape) if x.grad is None else x.grad.numpy(), g)
                          for x, g in zip(xs, g_in))}
    if want:
        errs["params"] = rel_l2(got, want)
    return errs
