"""The OC20 S2EF slice: the port's EquiformerV2OC20 and its train step
against the JAX package's.

One layer at narrow widths (16 channels, 2 heads, FFN 32) with OC20's
lmax 6 / mmax 2, the default S2 grid and the factored Wigner
representation on both sides (the JAX package's CPU path; the port's
kernel K4 in its plain version).  Random Flax params, made by numpy from a
seed, move to the port through utils/convert.py; the same fixed-degree
batch of two small periodic structures goes through both.  Tolerances:
energies and forces 1e-5 relative to their largest magnitude; one f32
step's loss 1e-5 relative, gradients 1e-4 relative L2.  ``pytest -s``
prints the measured errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.models.oc20 import (
    EquiformerV2OC20 as JaxOC20,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs import oc20 as oc_cfg
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import init_weights
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.oc20 import (
    EquiformerV2OC20,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.rotation import WignerFactors
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_oc20 import (
    build_oc20_model,
    predict,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    cast_params,
    create_train_state,
    make_oc20_train_step,
    oc20_loss,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

CFG = dict(num_layers=1, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=6, mmax=2, edge_channels=16, num_rbf=16, max_num_elements=20,
           cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0, avg_num_nodes=6.0,
           avg_degree=5.0)
CUTOFF, MAX_NEIGHBORS = 5.0, 8


def _batch():
    """Two periodic structures of 5 and 7 atoms with energy / force labels
    and fixed-atom tags, fixed-degree layout."""
    rng = np.random.default_rng(0)
    samples = []
    for n in (5, 7):
        cell = (np.eye(3) * 4.5 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        samples.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 20, size=n).astype(np.int32),
            pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32), cell=cell,
            pbc=True, energy=float(rng.normal()),
            forces=rng.normal(size=(n, 3)).astype(np.float32), fixed=rng.uniform(size=n) < 0.3))
    pb = tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, 16, 16 * MAX_NEIGHBORS,
                        fixed_degree=True)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


def _random_flax_params(jm, batch, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its params, its outputs and its loss gradients: one
    compile of each."""
    jb, tb = _batch()
    jm = JaxOC20(**CFG, fixed_degree=True, uniform_blocks=True, wigner_rep="factored")
    params = _random_flax_params(jm, jb, seed=1)
    outs = jax.jit(lambda p, b: jm.apply(p, b))(params, jb)

    def loss_fn(p):
        o = jm.apply(p, jb, deterministic=False)
        return jtrainer.oc20_loss(o["energy"], jb["energy"], o["forces"], jb["forces"],
                                  jb["node_mask"])[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(tb=tb, params=params, energy=np.asarray(outs["energy"]),
                forces=np.asarray(outs["forces"]), loss=float(loss),
                grads=flax_to_state_dict(grads))


def _port_model(params, **kw):
    model = EquiformerV2OC20(**CFG, **kw)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def test_oc20_forward_matches_jax(setup):
    model = _port_model(setup["params"]).eval()
    with torch.no_grad():
        out = model(setup["tb"])
    assert out["energy"].shape == (2,) and out["forces"].shape == (16, 3)
    e_err = _rel(out["energy"].numpy(), setup["energy"])
    f_err = _rel(out["forces"].numpy(), setup["forces"])
    print(f"OC20 forward: energy rel err {e_err:.2e}, forces rel err {f_err:.2e}")  # pytest -s
    assert e_err <= 1e-5 and f_err <= 1e-5, (e_err, f_err)
    assert not out["forces"][~setup["tb"]["node_mask"]].any()


def test_oc20_factored_matches_dense(setup):
    """The same weights on the port's two Wigner representations."""
    outs = {}
    for rep in ("factored", "dense"):
        model = _port_model(setup["params"], wigner_rep=rep).eval()
        with torch.no_grad():
            outs[rep] = model(setup["tb"])
    for k in ("energy", "forces"):
        err = _rel(outs["factored"][k].numpy(), outs["dense"][k].numpy())
        assert err <= 1e-5, (k, err)


def test_oc20_train_step_matches_jax(setup):
    """One f32 step's loss and gradients; then make_oc20_train_step on the
    same weights reports the same loss and applies the update."""
    model = _port_model(setup["params"]).train()
    tb = setup["tb"]
    outs = model(tb)
    loss, _ = oc20_loss(outs["energy"], tb["energy"], outs["forces"], tb["forces"],
                        tb["node_mask"])
    loss.backward()
    loss = float(loss.detach())
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    assert grads.keys() == setup["grads"].keys()
    loss_err = abs(loss - setup["loss"]) / abs(setup["loss"])
    grad_err = _rel_l2(grads, setup["grads"])
    print(f"OC20 step: loss rel err {loss_err:.2e}, gradient rel L2 err {grad_err:.2e}")
    assert loss_err <= 1e-5 and grad_err <= 1e-4, (loss_err, grad_err)

    model = _port_model(setup["params"])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                   lambda step: 1e-3, 1e-3, 1.0))
    step_loss, m = make_oc20_train_step(state)(tb)
    assert m["accepted"] and abs(float(step_loss) - loss) <= 1e-6 * abs(loss)
    assert any(not torch.equal(before[n], p) for n, p in model.named_parameters())


def test_oc20_bf16_step_runs():
    """bfloat16 compute with float32 masters (the card's OC20 phase): finite
    loss and float32 gradients on every parameter."""
    _, tb = _batch()
    model = EquiformerV2OC20(**{**CFG, "lmax": 2, "mmax": 1}, compute_dtype=torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0))
    state = create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                   lambda step: 1e-3, 1e-3, 1.0))
    loss, m = make_oc20_train_step(state)(tb)
    assert torch.isfinite(loss) and m["accepted"]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    # evaluation with the float32 EMA weights runs on their bfloat16 copies
    out = predict(model, tb, state.ema)
    assert all(torch.isfinite(v).all() for v in out.values())


def test_oc20_bf16_step_matches_jax():
    """The bf16 OC20 step against the JAX package's, from the same converted
    weights and batch, on the factored Wigner representation (the port's
    kernel K4 in its plain version; the JAX package's XLA chain, which
    rounds h and uv to bf16 after each product, where the port rounds
    once).  Limits, relative to max |JAX|: energies, forces and loss 2e-2,
    gradients 5e-2 relative L2 (the MatPES bf16 limits,
    tests/test_torch_train.py)."""
    jb, tb = _batch()
    cfg = {**CFG, "lmax": 2, "mmax": 1}
    jm = JaxOC20(**cfg, fixed_degree=True, uniform_blocks=True, wigner_rep="factored",
                 compute_dtype="bfloat16")
    params = _random_flax_params(jm, jb, seed=2)

    def loss_fn(p):
        o = jm.apply(jtrainer.cast_params(p, jnp.bfloat16), jb, deterministic=False)
        loss = jtrainer.oc20_loss(o["energy"].astype(jnp.float32), jb["energy"],
                                  o["forces"].astype(jnp.float32), jb["forces"],
                                  jb["node_mask"])[0]
        return loss, o

    (loss_j, outs_j), grads_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = EquiformerV2OC20(**cfg, compute_dtype=torch.bfloat16)
    model.load_state_dict(flax_to_state_dict(params))
    model.train()
    outs = torch.func.functional_call(model, cast_params(model, torch.bfloat16), (tb,))
    loss, _ = oc20_loss(outs["energy"], tb["energy"], outs["forces"], tb["forces"],
                        tb["node_mask"])
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    errs = dict(
        energy=_rel(outs["energy"].detach().float().numpy(),
                    np.asarray(outs_j["energy"], np.float32)),
        forces=_rel(outs["forces"].detach().float().numpy(),
                    np.asarray(outs_j["forces"], np.float32)),
        loss=abs(float(loss.detach()) - float(loss_j)) / abs(float(loss_j)),
        grads=_rel_l2(grads, flax_to_state_dict(grads_j)))
    print("OC20 bf16 step against JAX: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert errs["energy"] <= 2e-2 and errs["forces"] <= 2e-2 and errs["loss"] <= 2e-2, errs
    assert errs["grads"] <= 5e-2, errs


@pytest.mark.parametrize("name", ["config", "config_debug", "config_synthetic"])
def test_oc20_configs_build_the_factored_model(name):
    cfg = getattr(oc_cfg, name)
    assert cfg["wigner_rep"] == "factored" and cfg["run_dir"].startswith("runs/oc20_torch")
    model = build_oc20_model({**cfg, "num_layers": 1})
    assert model.backbone.wigner_rep == "factored"
    assert (model.backbone.lmax, model.backbone.mmax) == (cfg["lmax"], cfg["mmax"])


def test_backbone_names_the_unported_wigner_representation():
    # every representation of the JAX package is ported; another is refused
    # with the list of the three
    with pytest.raises(ValueError, match="'dense', 'factored', 'blocks'"):
        EquiformerV2OC20(**CFG, wigner_rep="sparse")


def test_factored_tables_are_built_once_per_forward(setup):
    """Every rotate of a forward shares the WignerFactors' K4 tables."""
    model = _port_model(setup["params"]).eval()
    seen = []
    hook = model.backbone.register_forward_hook(lambda m, a, out: seen.append(out.wigner))
    with torch.no_grad():
        model(setup["tb"])
    hook.remove()
    (w,) = seen
    assert isinstance(w, WignerFactors)
    # the attention's to / from, the embedding's from and the force head's
    assert set(k[0] for k in w._tables) == {"to", "from"}
