"""The DP x GPipe pipeline (the port's parallel/pipeline.py) on gloo ranks
on the CPU, against the JAX package.

* The executor: ``pipeline_apply`` at pipe 2 (the mesh (2, 2): each data
  row runs its own pipeline) and pipe 4, M = 1 and 3 micro-batches, against
  the same blocks run one after another in one process: forward, the
  gradient by the inputs (kept) and the gradients of a loss of both
  (grad-of-grad).  A toy block stack in float64 to 1e-10; the model's
  blocks, whose norms and softmax compute in float32, through
  ``pipeline_energy_forces`` against ``matpes_energy_forces`` to 1e-6
  relative (energies, forces, and every gradient of the summed loss).
* Zeros: an all-zero state (the pipeline's bubble) through one block gives
  finite values, gradients and grad-of-grad.
* The step at (data, pipe) = (1, 2) and (2, 2), two micro-batches (M = 2
  on the one row of (1, 2), M = 1 on each row of (2, 2)), in the JAX
  pipeline tests' ``TINY`` configuration (tests/test_pipeline_trainer.py),
  against the JAX package's ``make_pipeline_matpes_step`` on the same
  meshes of the virtual CPU devices: loss and metrics within 1e-5
  relative, the masters and EMA within 1e-2 lr (lr where the reference
  gradient is rounding noise of an exact zero: Adam's first step
  normalizes it, tests/test_torch_sharding.py); the gradients against
  ``jax.grad`` of the JAX package's single-device loss within 1e-5
  relative L2 (the JAX pipeline step returns no gradient; its own test
  holds it to the single-device step).  One bf16 case, (1, 2): loss and
  gradients within 5e-2 (the repository's bf16 step limit,
  tests/test_torch_train.py) of the JAX package's single-device loss on
  bfloat16 copies of the masters (``cast_params``, which its pipeline step
  calls too); its masters are not compared (Adam's first step turns a
  bf16 gradient's sign noise into lr-sized moves).
* Sharding: stage-shard then gather is bit-identical, so is loading a
  whole state into a sharded one; every rank of a row holds bit-identical
  replicated leaves and loss after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_helpers as H
import torch_pipeline_helpers as PH
import torch_sharding_helpers as S
import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
)
from equivarianttransformermpnn4quantumcomputations_tpu.parallel.data_parallel import (
    stack_microbatches as jax_stack,
)
from equivarianttransformermpnn4quantumcomputations_tpu.parallel.pipeline import (
    make_dp_pipe_mesh as jax_mesh,
    make_pipeline_matpes_step as jax_pipeline_step,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.backbone import (
    block_step,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel.pipeline import (
    _flatten,
    _unflatten,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)
from test_pipeline_trainer import TINY

PORT_TINY = {k: v for k, v in TINY.items() if k not in ("remat", "scan_layers")}
CASES = {"f32 (1, 2)": ((1, 2), False), "bf16 (1, 2)": ((1, 2), True),
         "f32 (2, 2)": ((2, 2), False)}


def _micro(seed: int, n: int = 5):
    """tests/test_pipeline_trainer.py's ``_micro``, batched by the port's
    fixed-degree collate (8 nodes x 8 slots, so at most 8 neighbours: 5
    atoms have 4), which the JAX model runs too."""
    rng = np.random.default_rng(seed)
    s = tgraph.GraphSample(
        atomic_numbers=rng.integers(1, 15, size=n).astype(np.int32),
        pos=(rng.normal(size=(n, 3)) * 1.5).astype(np.float32), energy=float(rng.normal()),
        forces=rng.normal(size=(n, 3)).astype(np.float32) * 0.1)
    pb = tgraph.collate([s], 5.0, 8, 8, 64, fixed_degree=True)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return pb


def _jax_model(bf16: bool):
    return JaxMatPES(**{**TINY, **V.JAX_LAYOUT,
                        "compute_dtype": "bfloat16" if bf16 else "float32"})


def _jax_step(params, batches, mesh_shape) -> dict:
    """The JAX pipeline step's loss, metrics, masters and EMA (float32)."""
    jm = _jax_model(False)
    tx = jtrainer.make_optimizer(lambda count: S.LR, S.WD, 1.0)
    stacked = {k: jnp.asarray(v) for k, v in jax_stack([b.asdict() for b in batches]).items()}
    state = jtrainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = jax_pipeline_step(jm, tx, jax_mesh(*mesh_shape), jax.eval_shape(lambda: state),
                             stacked, ema_decay=S.EMA_DECAY)
    key = jax.random.PRNGKey(0)
    new, metrics = step.lower(state, stacked, key).compile(
        compiler_options=V.FAST_COMPILE)(state, stacked, key)
    return dict(loss=float(metrics["loss"]),
                metrics={k: float(metrics[k]) for k in ("energy_l1", "force_l1")},
                params=flax_to_state_dict(new.params), ema=flax_to_state_dict(new.ema_params))


def _jax_grads(params, batches, bf16: bool) -> dict:
    """The mean over ``batches`` of the JAX package's single-device loss and
    its gradients (``cast_params`` to bfloat16 first in bf16, as the
    pipeline and single-device mixed-precision steps do)."""
    jm = _jax_model(bf16)

    def loss_fn(p, b):
        if bf16:
            p = jtrainer.cast_params(p, jnp.bfloat16)
        outs = matpes_energy_forces_stress(jm, p, b, regress_stress=False)
        return jtrainer.matpes_loss(outs, b, 1.0, 1.0, 0.0)[0]

    jbs = [{k: jnp.asarray(v) for k, v in b.asdict().items()} for b in batches]
    fn = jax.jit(jax.value_and_grad(loss_fn)).lower(params, jbs[0]).compile(
        compiler_options=V.FAST_COMPILE)
    outs = [fn(params, b) for b in jbs]
    grads = jax.tree_util.tree_map(lambda *g: sum(g) / len(g), *[o[1] for o in outs])
    return dict(loss=sum(float(o[0]) for o in outs) / len(outs),
                grads=flax_to_state_dict(grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on its ranks (2 for (1, 2), 4 for (2, 2) and the
    executor), and the JAX side computed while they run."""
    batches = [_micro(i) for i in range(2)]
    jb = {k: jnp.asarray(v) for k, v in batches[0].asdict().items()}
    params = V.random_flax_params(_jax_model(False), jb, 7)
    weights = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    cases = {}
    for name, (mesh, bf16) in CASES.items():
        cfg = dict(PORT_TINY, compute_dtype=torch.bfloat16) if bf16 else PORT_TINY
        cases[name] = dict(kind="matpes", cfg=cfg, weights=weights, batches=batches,
                           lr=S.LR, wd=S.WD, mesh=mesh)
    out2, out4 = tmp_path_factory.mktemp("pipe2"), tmp_path_factory.mktemp("pipe4")
    two = {k: v for k, v in cases.items() if v["mesh"] == (1, 2)}
    procs = (H.start(PH.step_worker, 2, 2, H.free_port(), str(out2), two, 1, True, False)
             + H.start(PH.step_worker, 4, 4, H.free_port(), str(out4),
                       {"f32 (2, 2)": cases["f32 (2, 2)"]}, 1, False, True))
    grads = {bf16: _jax_grads(params, batches, bf16) for bf16 in (False, True)}
    want = {name: {**grads[bf16], **({} if bf16 else _jax_step(params, batches, mesh))}
            for name, (mesh, bf16) in CASES.items()}
    codes = H.join(procs[:2]) + H.join(procs[2:])
    assert codes == [0] * 6, f"rank exit codes {codes}"
    got = [torch.load(out2 / f"rank{r}.pt", weights_only=False) for r in range(2)]
    got4 = [torch.load(out4 / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return want, got, got4


EXEC = ["pipe=2,M=1", "pipe=2,M=3", "pipe=4,M=1", "pipe=4,M=3"]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


@pytest.mark.parametrize("key", EXEC)
def test_executor_matches_the_sequential_stack(key, runs):
    """Every rank: the toy stack in float64 to 1e-10 and the model's blocks
    in float32 to 1e-6 (forward, forces, every gradient of the stage's
    blocks and of the replicated leaves)."""
    for rank, res in enumerate(runs[2]):
        r = res["executor"][key]
        toy, ref = r["toy"], r["toy_ref"]
        errs = [_rel(toy[k], ref[k]) for k in ("out", "du", "u_grad")]
        errs += [_rel(toy["w_grads"][l], ref["w_grads"][l]) for l in toy["w_grads"]]
        assert max(errs) <= 1e-10, (rank, key, errs)
        m, mr = r["model"], r["model_ref"]
        assert set(m["grads"]) == {n for n in mr["grads"] if not n.startswith(
            "backbone.blocks.") or int(n.split(".")[2]) in r["stage"]}
        errs = [_rel(m[k], mr[k]) for k in ("energy", "forces")]
        errs += [_rel(g, mr["grads"][n]) for n, g in m["grads"].items()]
        assert max(errs) <= 1e-6, (rank, key, max(errs))
        P = int(key.split(",")[0].split("=")[1])
        M = int(key.split("=")[-1])
        assert r["ticks"] == M + P - 1 and r["bubble"] == P - 1, (r["ticks"], r["bubble"])


def test_zero_state_through_a_block_is_finite():
    """The bubble's state (zero features and streams, zero Wigner tables,
    every edge masked) through a block: finite output, gradient by x (kept)
    and the gradients of a loss of both by every parameter."""
    model = EquiformerV2MatPES(**PORT_TINY)
    init_weights(model, torch.Generator().manual_seed(0))
    model.train()
    batch = tgraph.as_tensors(_micro(0), "cpu")
    carry, bc = model(batch, stack_capture=True)
    leaves, spec = _flatten(carry, bc)
    zeros = tuple(None if t is None else torch.zeros_like(t) for t in leaves)
    (x, t_ij, a_ij), bc0 = _unflatten(zeros, spec)
    assert not bc0.edge_mask.any() and float(bc0.wigner.v_to.abs().sum()) == 0.0
    x = x.requires_grad_(True)
    t_ij = t_ij.requires_grad_(True)
    out, t_out, _ = block_step(model.backbone.blocks[0], (x, t_ij, a_ij), bc0, 1)
    assert torch.isfinite(out).all() and torch.isfinite(t_out).all()
    energy = (torch.sin(out) ** 2).sum() + t_out.sum()
    dx, dt = torch.autograd.grad(energy, (x, t_ij), create_graph=True)
    assert torch.isfinite(dx).all() and torch.isfinite(dt).all()
    ((dx * dx).sum() + (dt * dt).sum() + energy).backward()
    for n, p in model.backbone.blocks[0].named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), n


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_step_matches_jax(name, runs):
    want_all, got2, got4 = runs
    got = (got2 if CASES[name][0] == (1, 2) else got4)[0][name]
    want = want_all[name]
    bf16 = CASES[name][1]
    assert got["accepted"]
    err_l = abs(got["loss"] / want["loss"] - 1)
    err_g = V.rel_l2(got["grads"], want["grads"])
    print(f"{name}: loss {err_l:.2e}, gradients {err_g:.2e}")   # pytest -s
    if bf16:
        assert err_l <= 5e-2 and err_g <= 5e-2, (err_l, err_g)
        return
    err_m = max(abs(got["metrics"][k] / want["metrics"][k] - 1) for k in want["metrics"])
    assert err_l <= 1e-5 and err_m <= 1e-5 and err_g <= 1e-5, (err_l, err_m, err_g)
    gmax = max(float(g.abs().max()) for g in want["grads"].values())
    for part in ("params", "ema"):
        assert got[part].keys() == want[part].keys()
        for k, v in got[part].items():
            noise = want["grads"][k].abs() <= 1e-6 * gmax
            atol = torch.where(noise, 1.01 * S.LR, 1e-2 * S.LR)
            assert torch.all((v - want[part][k]).abs() <= atol), f"{part} {k}"


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree(name, runs):
    """Every rank of the mesh: the same loss, whole state and gradients,
    and bit-identical replicated leaves."""
    _, got2, got4 = runs
    ranks = got2 if CASES[name][0] == (1, 2) else got4
    ref = ranks[0][name]
    for r in ranks[1:]:
        assert r[name]["loss"] == ref["loss"]
        for key in ("params", "ema", "replicated"):
            for k, v in ref[key].items():
                assert torch.equal(r[name][key][k], v), (key, k)


def test_shard_gather_roundtrip(runs):
    """Shard then gather, and load a whole state into a sharded one then
    gather: both equal the whole state bit for bit; each stage holds its
    block and every replicated leaf."""
    _, got2, _ = runs
    for rank, res in enumerate(got2):
        rt = res["roundtrip"]
        assert [n for n in rt["names"] if n.startswith("backbone.blocks.")] == sorted(
            n for n in rt["whole"]["model"] if n.startswith(f"backbone.blocks.{rank}."))
        for got in (rt["gathered"], rt["reloaded"]):
            assert got["step"] == rt["whole"]["step"]
            for part in ("model", "ema"):
                assert list(got[part]) == list(rt["whole"][part])
                for k, v in rt["whole"][part].items():
                    assert torch.equal(got[part][k].cpu(), v.cpu()), (part, k)
            w_opt, g_opt = rt["whole"]["optimizer"], got["optimizer"]
            assert {k: v for k, v in w_opt.items() if k != "adamw"} == {
                k: v for k, v in g_opt.items() if k != "adamw"}
            assert w_opt["adamw"]["param_groups"] == g_opt["adamw"]["param_groups"]
            assert w_opt["adamw"]["state"].keys() == g_opt["adamw"]["state"].keys()
            for i, st in w_opt["adamw"]["state"].items():
                for k, v in st.items():
                    assert torch.equal(g_opt["adamw"]["state"][i][k].cpu(), v.cpu()), (i, k)
