"""The composite DP x TP x EP x SP step (the port's parallel/sharding.py and
nn/partition.py) at one data row of 2 model ranks (gloo, spawned once for
the file), against the JAX package.

* The roles: the port's ``param_roles`` equals the JAX package's
  ``param_partition_spec`` leaf by leaf (names through utils/convert.py,
  the sharded dimension through its transposes) for the GATA-V2, GATA v1,
  baseline, MoE and dual-stream presets at model = 2, and with a width 3
  does not divide (the fallback: replicated whole).
* The region functions in a small Megatron pair, in float64: forward,
  gradient and grad-of-grad equal the one-process math to 1e-12; so do
  the ragged layout's sequence-parallel segment sum and mean, and its
  segment softmax (float32 statistics) to 1e-5.
* ``edge_shard``: the even split of the edge axis and the node rows, and
  the whole axis where the split does not divide.
* ``shard_state`` -> ``gather_state`` is bit-identical, and so is loading a
  whole state into a sharded one and gathering it.
* The step at (data, model) = (1, 2), ``sp`` off and on, with EP, with
  stress and in bf16, and with ``sp`` in the ragged and uniform layouts
  (their batches straddle a node's edges across the ranks and put padded
  edges on the last rank), against the mean loss of the JAX package's
  unsharded step in the same layout (tests/torch_sharding_helpers.py): loss 2e-5 relative (the JAX
  sharding test's limit), gradients 1e-4 relative L2 (float32 sums in
  another order, then a double backward; tests/test_torch_train.py),
  parameters and EMA 1e-2 x lr absolute (tests/test_torch_parallel.py),
  lr where the reference gradient is rounding noise of an exact zero
  (Adam's first step normalizes it: the stress case's energy-head bias,
  whose true gradient is 0, reads -4.5e-8 in JAX and -1.5e-8 in the port's
  own one-process step);
  bf16: loss 2e-2 relative, gradients 5e-2 relative L2
  (tests/test_torch_oc20.py's and test_torch_train.py's bf16 limits).
* With dropout on, and for the dual stream under SP (fixed-degree and
  ragged), the step equals the port's own model = 1 step on the same micro-batch and seed: 1e-6
  relative (the dual stream's one-process energies and forces are held
  against JAX in tests/test_torch_variants_models_*.py).
* At model = 1 the composite step is the data-parallel step, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_parallel_helpers as H
import torch_sharding_helpers as S
import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.parallel.sharding import (
    param_partition_spec,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.partition import param_roles
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import (
    data_parallel,
    sharding,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import port_name

PRESETS = {"gatav2": {}, "gata_v1": dict(gata=False, gata_v1=True, mmax=2),
           "baseline": dict(gata=False), "moe": dict(ffn_variant="moe", num_experts=4),
           "dual_stream": dict(dual_stream=True, ffn_variant="tensor_product")}


def _jax_roles(jm, batch, size: int) -> dict:
    """port name -> the torch dimension the JAX spec shards (or None)."""
    specs = param_partition_spec(jm, batch, size)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))
    flat_s = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    shape_of = {jax.tree_util.keystr(p): v.shape
                for p, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    out = {}
    for path, spec in flat_s:
        keys = tuple(str(k.key) for k in path)[1:]          # without "params"
        nd = len(shape_of[jax.tree_util.keystr(path)])
        dims = [d for d, a in enumerate(tuple(spec)) if a is not None]
        assert len(dims) <= 1, (keys, spec)
        d = dims[0] if dims else None
        if d is not None and keys[-1] == "kernel" and d >= nd - 2:
            d = 2 * nd - 3 - d                               # [.., in, out] -> [.., out, in]
        out[port_name(keys)] = d
    return out


@pytest.mark.parametrize("preset,size", [(p, 2) for p in PRESETS] + [("gatav2", 3)])
def test_param_roles_match_jax(preset, size):
    kw = PRESETS[preset]
    jm = S.jax_model(**kw)
    jb = {k: np.asarray(v) for k, v in S.crystals(0).asdict().items()}
    want = _jax_roles(jm, jb, size)
    got = param_roles(EquiformerV2MatPES(**{**S.TINY, **kw}), size)
    assert got == want
    sharded = sum(d is not None for d in got.values())
    print(f"{preset} at model={size}: {sharded} of {len(got)} leaves sharded")
    assert sharded > (10 if size == 2 else 0)
    if size == 3:   # 8 channels do not split in 3: the FFN stays whole
        assert got["backbone.blocks.0.ffn.so3_linear_1.weight"] is None


JAX_CHECKED = ("f32", "f32_sp", "moe", "stress", "bf16", "f32_sp_ragged", "f32_sp_uniform",
               "bf16_sp_ragged", "stress_sp_ragged", "moe_sp_ragged")
# the cases whose edge axis splits inside a node's incoming edges
SPLIT_LAYOUT_CASES = ("f32_sp_ragged", "f32_sp_uniform", "bf16_sp_ragged", "stress_sp_ragged",
                      "moe_sp_ragged", "dropout_sp_ragged", "dual_stream_sp_ragged")
CASES = {
    "f32": lambda: S.case(2, False),
    "f32_sp": lambda: S.case(2, True),
    "moe": lambda: S.case(2, False, kw=PRESETS["moe"], seed=3),
    "stress": lambda: S.case(2, True, stress=True, seed=5),
    "bf16": lambda: S.case(2, False, kw=dict(compute_dtype="bfloat16"), seed=8),
    "dropout": lambda: S.case(2, False, cfg_kw=dict(alpha_drop=0.3, drop_path_rate=0.3,
                                                    proj_drop=0.2)),
    "dropout_sp": lambda: S.case(2, True, cfg_kw=dict(alpha_drop=0.3, drop_path_rate=0.3)),
    "dual_stream_sp": lambda: S.case(2, True, kw=PRESETS["dual_stream"], seed=9),
    "f32_sp_ragged": lambda: S.case(2, True, layout="ragged"),
    "f32_sp_uniform": lambda: S.case(2, True, layout="uniform"),
    "bf16_sp_ragged": lambda: S.case(2, True, kw=dict(compute_dtype="bfloat16"), seed=8,
                                     layout="ragged"),
    "stress_sp_ragged": lambda: S.case(2, True, stress=True, seed=5, layout="ragged"),
    "moe_sp_ragged": lambda: S.case(2, True, kw=PRESETS["moe"], seed=3, layout="ragged"),
    "dropout_sp_ragged": lambda: S.case(2, True, cfg_kw=dict(alpha_drop=0.3,
                                                             drop_path_rate=0.3),
                                        layout="ragged"),
    "dual_stream_sp_ragged": lambda: S.case(2, True, kw=PRESETS["dual_stream"], seed=9,
                                            layout="ragged"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's step at 2 gloo ranks (one data row of 2 model ranks),
    the region checks and the shard / gather round trip, and the JAX
    references computed meanwhile: (cases with their JAX inputs, [rank 0's
    results, rank 1's], JAX references by case)."""
    out = tmp_path_factory.mktemp("tp")
    made = {name: make() for name, make in CASES.items()}
    cases = {name: c for name, (c, _, _) in made.items()}
    procs = H.start(H.composite_worker, 2, 2, H.free_port(), str(out), cases, 1, True)
    refs = {}
    for name in JAX_CHECKED:
        if name == "f32_sp":   # the same case as f32: the same reference
            continue
        case, jm, params = made[name]
        refs[name] = S.jax_reference(jm, params, case["batches"],
                                     case["step_kw"].get("w_stress", 0.0))
    refs["f32_sp"] = refs["f32"]
    codes = H.join(procs)
    assert codes == [0, 0], f"rank exit codes {codes}"
    return made, [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)], refs


def test_region_functions_match_one_process_math(ranks):
    _, results, _ = ranks
    for r in results:
        for kind, err in r["regions"].items():
            assert err <= 1e-12, (kind, err)


def test_sp_segment_functions_match_one_process_math(ranks):
    """The ``reduce_scatter`` node sums and means and the distributed segment
    softmax (ops/segment.py with a ragged ``EdgeShard``) to the second
    derivative, on ids that straddle the ranks: the sums in float64 to
    1e-12; the softmax, whose statistics are float32 in one process too
    (the ranks' partial denominators add in another order), to 1e-5."""
    _, results, _ = ranks
    for r in results:
        got = r["sp_regions"]
        assert got["straddling"] > 0
        assert got["sums"] <= 1e-12 and got["softmax"] <= 1e-5, got


@pytest.mark.parametrize("N,E,M", [(12, 72, 2), (12, 80, 2), (18, 120, 2), (16, 96, 4)])
def test_edge_shard_splits_evenly(N, E, M):
    """Rank r of M takes edges [r E/M, (r+1) E/M) and rows [r N/M, (r+1) N/M):
    the ranks' slices tile both axes; ``fixed`` is carried; no ``sp``, no
    shard."""
    shards = [sharding.ModelGroup(M, r, sp=True).edge_shard(N, E, fixed=True)
              for r in range(M)]
    assert [(s.edges.start, s.edges.stop) for s in shards] == [
        (r * E // M, (r + 1) * E // M) for r in range(M)]
    assert [(s.rows.start, s.rows.stop) for s in shards] == [
        (r * N // M, (r + 1) * N // M) for r in range(M)]
    assert all(s.fixed and s.mp.rank == r for r, s in enumerate(shards))
    assert sharding.ModelGroup(M, 0).edge_shard(N, E) is None


@pytest.mark.parametrize("N,E,M", [(12, 70, 4), (10, 72, 4), (12, 72, 1)])
def test_edge_shard_stays_whole(N, E, M):
    """Where M does not divide E_pad or N_pad (or M = 1) the edge axis stays
    whole, as the JAX package's ``batch_shardings`` leaves it."""
    assert sharding.ModelGroup(M, 0, sp=True).edge_shard(N, E) is None


@pytest.mark.parametrize("name", SPLIT_LAYOUT_CASES)
def test_sp_batches_straddle_the_rank_boundary(name, ranks):
    """The ragged and uniform cases exercise the partial sums: a node's real
    incoming edges lie on both ranks, and the last rank holds padded
    edges."""
    made, _, _ = ranks
    for pb in made[name][0]["batches"]:
        straddling, padded_last = S.split_facts(pb, 2)
        assert straddling >= 1 and padded_last >= 1, (straddling, padded_last)


def test_shard_then_gather_is_bit_identical(ranks):
    _, results, _ = ranks
    for r in results:
        rt = r["roundtrip"]
        for got in (rt["gathered"], rt["reloaded"]):
            for part in ("model", "ema"):
                assert got[part].keys() == rt["whole"][part].keys()
                for k, v in rt["whole"][part].items():
                    assert torch.equal(got[part][k], v), (part, k)
            adam_w, adam_g = (x["optimizer"]["adamw"]["state"] for x in (rt["whole"], got))
            assert adam_w.keys() == adam_g.keys() and adam_w
            for i, st in adam_w.items():
                for k, v in st.items():
                    assert torch.equal(adam_g[i][k], v), (i, k)
            assert got["step"] == rt["whole"]["step"]
    # the ranks hold halves of the sharded leaves
    full = rt["whole"]["model"]
    halves = [k for k, s in rt["shard_shapes"].items() if s != tuple(full[k].shape)]
    assert len(halves) > 10
    assert all(np.prod(rt["shard_shapes"][k]) * 2 == full[k].numel() for k in halves)


def _check_against_jax(name, ranks, bf16=False):
    _, results, refs = ranks
    want, got = refs[name], results[0][name]
    rtol_loss, tol_grad = (2e-2, 5e-2) if bf16 else (2e-5, 1e-4)
    err_l = abs(got["loss"] / want["loss"] - 1)
    err_g = _rel_l2(got["grads"], want["grads"])
    print(f"{name}: loss {err_l:.2e}, gradients {err_g:.2e}, collectives "
          f"{got['collectives']}")   # pytest -s
    assert err_l <= rtol_loss, err_l
    for k in want["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=rtol_loss,
                                   err_msg=k)
    assert err_g <= tol_grad, err_g
    if not bf16:
        # Adam's first step is lr g / (|g| + eps): where the reference
        # gradient is float32 rounding of an exact zero (below 1e-6 of the
        # largest), either side may move by up to lr; elsewhere 1e-2 lr
        gmax = max(float(g.abs().max()) for g in want["grads"].values())
        for part in ("params", "ema"):
            assert got[part].keys() == want[part].keys()
            for k, v in got[part].items():
                noise = want["grads"][k].abs() <= 1e-6 * gmax
                atol = torch.where(noise, 1.01 * S.LR, 1e-2 * S.LR)
                assert torch.all((v - want[part][k]).abs() <= atol), f"{part} {k}"


def _rel_l2(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    return V.rel_l2(got, want)


@pytest.mark.parametrize("name", ["f32", "f32_sp"])
def test_composite_step_matches_jax(name, ranks):
    _check_against_jax(name, ranks)


def test_expert_parallel_step_matches_jax(ranks):
    _check_against_jax("moe", ranks)


def test_stress_step_matches_jax(ranks):
    _check_against_jax("stress", ranks)


def test_bf16_step_matches_jax(ranks):
    _check_against_jax("bf16", ranks, bf16=True)


@pytest.mark.parametrize("name", ["f32_sp_ragged", "f32_sp_uniform", "bf16_sp_ragged",
                                  "stress_sp_ragged", "moe_sp_ragged"])
def test_sp_in_ragged_and_uniform_layouts_matches_jax(name, ranks):
    """``sp`` in the ragged and graph-uniform layouts (partial sums completed
    over ``model``) against JAX's unsharded step in the same layout, at the
    fixed-degree cases' limits."""
    _check_against_jax(name, ranks, bf16=name.startswith("bf16"))


def _one_process_step(case):
    state = H.new_state(case)
    gen = torch.Generator().manual_seed(data_parallel.rank_seed(case["seed"], 0))
    step = data_parallel.make_matpes_dp_step(state, 1, generator=gen, **case["step_kw"])
    stacked = data_parallel.stack_microbatches(
        [tgraph.as_tensors(b, "cpu") for b in case["batches"]])
    loss, _ = step(stacked)
    return float(loss), step.mean_grads(), dict(state.model.named_parameters()), state


@pytest.mark.parametrize("name", ["dropout", "dropout_sp", "dual_stream_sp", "dropout_sp_ragged",
                                  "dual_stream_sp_ragged"])
def test_step_matches_model_1(name, ranks):
    """Dropout on (the ranks draw the whole batch's masks and keep their
    share), and the dual stream under SP (its source-node sums reduced over
    the ranks), fixed-degree and ragged: the port's own one-process step."""
    made, results, _ = ranks
    case = made[name][0]
    loss, grads, params, state = _one_process_step(case)
    got = results[0][name]
    assert abs(got["loss"] / loss - 1) <= 1e-6
    assert V.rel_l2(got["grads"], grads) <= 1e-6
    assert V.rel_l2(got["params"], {k: p.detach() for k, p in params.items()}) <= 1e-6
    assert V.rel_l2(got["ema"], state.ema) <= 1e-6


@pytest.mark.parametrize("name", list(CASES))
def test_model_ranks_agree(name, ranks):
    """Both ranks end with the same gathered state and loss, bit for bit
    (the replicated leaves' gradients are averaged over the model ranks)."""
    _, (r0, r1), _ = ranks
    assert r0[name]["loss"] == r1[name]["loss"]
    for key in ("params", "ema"):
        for k, v in r0[name][key].items():
            assert torch.equal(v, r1[name][key][k]), (key, k)


def test_model_1_is_the_data_parallel_step():
    """One process, model = 1: nothing sharded, the data-parallel step's
    numbers bit for bit."""
    case = S.case(1, False)[0]
    loss, grads, params, _ = _one_process_step(case)
    state = H.new_state(case)
    mesh = sharding.make_composite_mesh(1)
    step = sharding.make_composite_matpes_step(
        state, mesh, 1, generator=torch.Generator().manual_seed(case["seed"]))
    got, _ = step(data_parallel.stack_microbatches(
        [tgraph.as_tensors(b, "cpu") for b in case["batches"]]))
    assert float(got) == loss and state.mesh is mesh and mesh.roles
    assert all(d is None for d in mesh.roles.values())
    for k, g in step.mean_grads().items():
        assert torch.equal(g, grads[k]), k
    for k, p in state.model.named_parameters():
        assert torch.equal(p, params[k]), k
