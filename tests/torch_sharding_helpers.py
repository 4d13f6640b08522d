"""Shared inputs and the JAX reference of the composite-step tests
(tests/test_torch_sharding.py, tests/test_torch_composite.py).

The model is the JAX package's own sharding-test configuration
(tests/test_sharding.py ``TINY``: 2 layers, 8 channels, lmax 2 / mmax 1,
2 heads, dropouts 0), without ``scan_layers`` (the layer stack's layout
changes no number).  Inputs are made by numpy from a seed and batched by
the port's fixed-degree collate, which the JAX model runs too.  Random
Flax params, made by numpy from a seed, move to the port through
utils/convert.py.

The reference is the math the JAX package holds its GSPMD step to
(tests/test_sharding.py ``reference_loss``): the mean over the
micro-batches of the force loss (per-graph stress when ``w_stress > 0``),
its gradient by ``jax.value_and_grad``, then one optax step of the JAX
package's guarded AdamW and the EMA.  The JAX side runs the dense Wigner
representation, as its own tests run it on the CPU, compiled at XLA's
lowest optimization level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
    matpes_energy_forces_stress_pergraph,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

TINY = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=8,
            lmax=2, mmax=1, edge_channels=8, num_rbf=16, max_num_elements=10,
            alpha_drop=0.0, drop_path_rate=0.0)
LR, WD, EMA_DECAY = 1e-3, 1e-3, 0.999
CUTOFF, MAX_NEIGHBORS = 5.0, 6


# layout -> (atoms per crystal, N_pad, E_pad, the collate's and the models'
# layout flags)
LAYOUTS = {
    "fixed_degree": ((4, 6), 12, 12 * MAX_NEIGHBORS, dict(fixed_degree=True),
                     dict(uniform_blocks=True, fixed_degree=True)),
    "ragged": ((4, 6), 12, 80, {}, dict(uniform_blocks=False, fixed_degree=False)),
    "uniform": ((4, 6, 5), 18, 120, dict(uniform=True),
                dict(uniform_blocks=True, fixed_degree=False)),
}


def crystals(seed: int, stress: bool = False, layout: str = "fixed_degree"):
    """Periodic crystals collated in ``layout``: fixed-degree, two (4 and 6
    atoms) padded to 12 nodes x 6 slots; ragged, the same two in 12 nodes
    and 80 edges; uniform, three (4, 6 and 5 atoms) in blocks of 6 nodes
    and 40 edges."""
    sizes, n_pad, e_pad, collate_kw, _ = LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    samples = []
    for n in sizes:
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        samples.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 9, size=n).astype(np.int32),
            pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32), cell=cell,
            pbc=True, energy=float(rng.normal()),
            forces=rng.normal(size=(n, 3)).astype(np.float32),
            stress=rng.normal(size=6).astype(np.float32) if stress else None))
    pb = tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, **collate_kw)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return pb


def split_facts(pb, size: int = 2) -> tuple[int, int]:
    """(the nodes whose real incoming edges lie on more than one of ``size``
    ranks' even slices of the edge axis, the padded edges on the last
    rank's)."""
    E = pb.edge_dst.shape[0]
    ranks = np.arange(E) // (E // size)
    real = pb.edge_mask
    owners = {}
    for d, r in zip(pb.edge_dst[real], ranks[real]):
        owners.setdefault(int(d), set()).add(int(r))
    straddling = sum(len(rs) > 1 for rs in owners.values())
    return straddling, int((~real[ranks == size - 1]).sum())


def jax_model(layout: str = "fixed_degree", **kw):
    return JaxMatPES(**{**TINY, **V.JAX_LAYOUT, **LAYOUTS[layout][4], **kw})


def case(model_size: int, sp: bool, n_micro: int = 1, kw: dict | None = None,
         stress: bool = False, seed: int = 0, cfg_kw: dict | None = None,
         layout: str = "fixed_degree"):
    """(case for the ranks, JAX model, Flax params): random Flax params of
    the JAX model with fields ``kw``, converted; ``cfg_kw`` only for the
    port (dropouts); the batches and both models in ``layout``."""
    kw = kw or {}
    batches = [crystals(seed + i, stress, layout) for i in range(n_micro)]
    jm = jax_model(layout, **kw)
    jb = {k: jnp.asarray(v) for k, v in batches[0].asdict().items()}
    params = V.random_flax_params(jm, jb, seed + 7)
    port_kw = {k: v for k, v in kw.items() if k != "compute_dtype"}
    if kw.get("compute_dtype") == "bfloat16":
        import torch
        port_kw["compute_dtype"] = torch.bfloat16
    weights = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    # the port's model in the layout of the batches
    c = dict(kind="matpes", cfg={**TINY, **LAYOUTS[layout][4], **port_kw, **(cfg_kw or {})},
             weights=weights,
             batches=batches, lr=LR, wd=WD, model=model_size, sp=sp, seed=seed,
             step_kw=dict(w_stress=0.1) if stress else {})
    return c, jm, params


def jax_reference(jm, params, batches, w_stress: float = 0.0) -> dict:
    """Loss, metrics, gradients, and the parameters and EMA after one step:
    the mean over ``batches`` of the JAX package's loss, one optax step."""

    def loss_fn(p, b):
        if w_stress > 0.0:
            outs = matpes_energy_forces_stress_pergraph(jm, p, b)
        else:
            outs = matpes_energy_forces_stress(jm, p, b, regress_stress=False)
        return jtrainer.matpes_loss(outs, b, 1.0, 1.0, w_stress)

    jbs = [{k: jnp.asarray(v) for k, v in pb.asdict().items()} for pb in batches]
    with flags.override(wigner="dense"):
        fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(params, jbs[0]).compile(
            compiler_options=V.FAST_COMPILE)
        outs = [fn(params, b) for b in jbs]
    n = len(outs)
    loss = sum(float(o[0][0]) for o in outs) / n
    metrics = {k: sum(float(o[0][1][k]) for o in outs) / n for k in outs[0][0][1]}
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / n, *[o[1] for o in outs])
    tx = jtrainer.make_optimizer(lambda count: LR, WD, 1.0)
    state = jtrainer.create_train_state(params, tx)
    updates, _ = tx.update(grads, state.opt_state, state.params)
    new = optax.apply_updates(state.params, updates)
    ema = jtrainer.ema_update(state.ema_params, new, EMA_DECAY)
    return dict(loss=loss, metrics=metrics, grads=flax_to_state_dict(grads),
                params=flax_to_state_dict(new), ema=flax_to_state_dict(ema))
