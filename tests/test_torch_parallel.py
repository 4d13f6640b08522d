"""Data-parallel steps across processes: the port's parallel/data_parallel.py
at 2 gloo ranks on the CPU (spawned once for the whole file, each rank on
its own micro-batch).

* QM9 and OC20 against the JAX package's ``make_qm9_dp_step`` /
  ``make_oc20_dp_step`` on a 2-device mesh (tests/conftest.py gives 8
  virtual CPU devices), from the same random Flax params through
  utils/convert.py: loss 1e-5 relative, updated parameters and EMA 1e-5
  absolute (1e-2 of the learning rate: Adam's update of a near-zero
  gradient is sign-like).  The JAX side runs the factored Wigner
  representation in XLA; the port's QM9 model runs the dense one (the
  only one it has; the two agree to float32 rounding), its OC20 model the
  factored one.
* The MatPES GATA-V2 force step, with and without the per-graph stress,
  against the mean of the port's two single-process gradients and the
  update it makes: 1e-6 relative L2 in f32 (the ranks run one thread each,
  this process more, so the last bits may differ).
* One process with data=2 against two ranks with one micro-batch each, and
  the two ranks' parameters and EMA bit-identical.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_helpers as H
from equivarianttransformermpnn4quantumcomputations_tpu.models.oc20 import (
    EquiformerV2OC20 as JaxOC20,
)
from equivarianttransformermpnn4quantumcomputations_tpu.models.qm9 import (
    EquiformerV2QM9 as JaxQM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu.parallel import data_parallel as jdp
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import init_weights
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    apply_updates,
    matpes_loss_grad,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

SMALL = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
             attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
             lmax=2, mmax=1, edge_channels=8, num_rbf=16, alpha_drop=0.0,
             drop_path_rate=0.0)
CUTOFF, K = 5.0, 6
LR, WD = 1e-3, 1e-3
# XLA's CPU backend at its lowest optimization level (these programs run once)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _molecules(seed):
    rng = np.random.default_rng(seed)
    samples = [tgraph.GraphSample(atomic_numbers=rng.integers(1, 9, size=n).astype(np.int32),
                                  pos=(rng.normal(size=(n, 3)) * 1.5).astype(np.float32),
                                  y=rng.normal(size=3).astype(np.float32)) for n in (5, 4)]
    return tgraph.collate(samples, CUTOFF, K, 12, 12 * K, fixed_degree=True)


def _crystals(seed, stress=False):
    rng = np.random.default_rng(seed)
    samples = []
    for n in (4, 5):
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        samples.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 9, size=n).astype(np.int32),
            pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32), cell=cell,
            pbc=True, energy=float(rng.normal()),
            forces=rng.normal(size=(n, 3)).astype(np.float32),
            stress=rng.normal(size=6).astype(np.float32) if stress else None))
    pb = tgraph.collate(samples, CUTOFF, K, 12, 12 * K, fixed_degree=True)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return pb


def _random_flax_params(jm, batch, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _jax_model(kind):
    # the factored Wigner: on the CPU the JAX package runs it in XLA (its
    # dense representation runs a Pallas kernel, which its shard_map refuses)
    layout = dict(fixed_degree=True, uniform_blocks=True, wigner_rep="factored")
    if kind == "qm9":
        return JaxQM9(**SMALL, num_targets=3, **layout)
    return JaxOC20(**SMALL, max_num_elements=10, cutoff=CUTOFF, **layout)


def _jax_case(kind):
    """The case for the ranks, and the JAX program's inputs."""
    batches = [_molecules(s) if kind == "qm9" else _crystals(s) for s in (1, 2)]
    jm = _jax_model(kind)
    params = _random_flax_params(jm, {k: np.asarray(v) for k, v in batches[0].asdict().items()},
                                 seed=3)
    cfg = (dict(SMALL, num_targets=3) if kind == "qm9"
           else dict(SMALL, max_num_elements=10, cutoff=CUTOFF))
    weights = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    case = dict(kind=kind, cfg=cfg, weights=weights, batches=batches, lr=LR, wd=WD, step_kw={})
    return case, jm, params


def _matpes_case(stress):
    cfg = dict(SMALL, grid_resolution=None, max_num_elements=10, cutoff=CUTOFF)
    model = init_weights(H.MODELS["matpes"](**cfg), torch.Generator().manual_seed(4))
    return dict(kind="matpes", cfg=cfg,
                weights={k: v.numpy() for k, v in model.state_dict().items()},
                batches=[_crystals(s, stress) for s in (5, 6)], lr=LR, wd=WD,
                step_kw=dict(w_stress=0.1) if stress else {})


CASES = {"qm9": lambda: _jax_case("qm9")[0], "oc20": lambda: _jax_case("oc20")[0],
         "matpes": lambda: _matpes_case(False), "matpes_stress": lambda: _matpes_case(True)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's step at 2 gloo ranks; (cases, [rank 0's, rank 1's])."""
    out = tmp_path_factory.mktemp("dp")
    cases = {name: make() for name, make in CASES.items()}
    codes = H.spawn(H.dp_worker, 2, 2, H.free_port(), str(out), cases, 1)
    assert codes == [0, 0], f"rank exit codes {codes}"
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert results[0]["backend"] == results[1]["backend"] == "gloo"
    return cases, results


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("kind", ["qm9", "oc20"])
def test_dp_step_matches_jax_on_a_two_device_mesh(kind, ranks):
    cases, results = ranks
    case, jm, params = _jax_case(kind)
    for a, b in zip(case["weights"].values(), cases[kind]["weights"].values()):
        np.testing.assert_array_equal(a, b)        # the ranks started from these
    mesh = jdp.make_mesh(2)
    batch = jdp.shard_batch(mesh, jdp.stack_microbatches([b.asdict() for b in case["batches"]]))
    tx = jtrainer.make_optimizer(lambda count: LR, WD, 1.0)
    state = jtrainer.create_train_state(params, tx)
    make = jdp.make_qm9_dp_step if kind == "qm9" else jdp.make_oc20_dp_step
    key = jax.random.PRNGKey(0)
    step = make(jm, tx, mesh).lower(state, batch, key).compile(compiler_options=FAST_COMPILE)
    jstate, jmetrics = step(state, batch, key)
    got = results[0][kind]
    print(f"{kind} DP against JAX: loss rel err "
          f"{abs(got['loss'] / float(jmetrics['loss']) - 1):.2e}, parameters max abs err "
          f"{max(float(np.abs(v.numpy() - flax_to_state_dict(jstate.params)[k].numpy()).max()) for k, v in got['params'].items()):.2e}")  # pytest -s
    np.testing.assert_allclose(got["loss"], float(jmetrics["loss"]), rtol=1e-5)
    for name in ("params", "ema"):
        want = flax_to_state_dict(jstate.params if name == "params" else jstate.ema_params)
        assert got[name].keys() == want.keys()
        for k, v in got[name].items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-2 * LR,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", ["matpes", "matpes_stress"])
def test_matpes_dp_step_is_the_mean_of_single_process_steps(name, ranks):
    cases, results = ranks
    case = cases[name]
    grads, losses = [], []
    for pb in case["batches"]:
        state = H.new_state(case)
        loss, _ = matpes_loss_grad(state, **case["step_kw"])(tgraph.as_tensors(pb, "cpu"))
        losses.append(float(loss))
        grads.append({n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                      for n, p in state.model.named_parameters()})
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}
    state = H.new_state(case)
    for n, p in state.model.named_parameters():
        p.grad = mean[n].clone()
    assert apply_updates(state)["accepted"]
    got = results[0][name]
    assert abs(got["loss"] - np.mean(losses)) <= 1e-6 * abs(np.mean(losses))
    assert ("stress_l1" in got["metrics"]) == (name == "matpes_stress")
    err_g = _rel_l2(got["grads"], mean)
    err_p = _rel_l2(got["params"], {k: p.detach() for k, p in state.model.named_parameters()})
    err_e = _rel_l2(got["ema"], state.ema)
    print(f"{name}: gradients {err_g:.2e}, parameters {err_p:.2e}, EMA {err_e:.2e}")
    assert max(err_g, err_p, err_e) <= 1e-6, (err_g, err_p, err_e)


def test_one_process_with_data_2_matches_two_ranks(ranks):
    cases, results = ranks
    got = H.run_case(cases["matpes"], [0, 1])
    want = results[0]["matpes"]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    for key in ("energy_l1", "force_l1"):
        assert abs(got["metrics"][key] - want["metrics"][key]) <= 1e-6 * abs(want["metrics"][key])
    for name in ("grads", "params", "ema"):
        assert _rel_l2(got[name], want[name]) <= 1e-6, name


@pytest.mark.parametrize("name", list(CASES))
def test_the_ranks_stay_bit_identical(name, ranks):
    _, (r0, r1) = ranks
    assert r0[name]["loss"] == r1[name]["loss"]
    for key in ("grads", "params", "ema"):
        for k, v in r0[name][key].items():
            assert torch.equal(v, r1[name][key][k]), f"{key} {k}"
    start = ranks[0][name]["weights"]
    assert any(not np.array_equal(v.numpy(), start[k]) for k, v in r0[name]["params"].items())
