"""The force-training slice: the port's trainer against the JAX package's.

Small configuration (2 layers, lmax 2 / mmax 1, 16 channels, as
tests/test_torch_model.py).  Inputs and random Flax params are made by numpy
from a seed; params move to the port through utils/convert.py.  The JAX side
runs as its own tests run it on the CPU (dense Wigner, its Pallas kernels in
interpret mode where its flags route them).

Tolerances: the guarded AdamW on identical gradients, 1e-6 relative.  One
float32 step: loss and metrics 1e-5 relative, gradients 1e-4 relative L2
(float32 sums in another order, then a double backward); parameters and EMA
after two steps 1e-2 * lr absolute (Adam's update of a near-zero gradient is
sign-like, so its error is bounded by lr, not relative).  The bfloat16 step:
loss 2e-2 relative, gradients 5e-2 relative L2 (bf16 rounds at other places
in the two frameworks; the measured values are in PERF.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.data import loader as jloader
from equivarianttransformermpnn4quantumcomputations_tpu.data import synthetic as jsynth
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import schedules as jsched
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import loader as tloader
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import synthetic as tsynth
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
    matpes_energy_forces,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.block import (
    EquivariantDropout,
    GraphDropPath,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import (
    schedules as tsched,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import train_matpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    cast_params,
    create_train_state,
    make_matpes_train_step,
    matpes_loss,
    wd_mask,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flatten,
    flax_to_state_dict,
    port_name,
)

CFG = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=2, mmax=1, grid_resolution=None, edge_channels=16, num_rbf=32,
           cutoff=5.0)
CUTOFF, MAX_NEIGHBORS = 5.0, 8
LR, WARMUP, TOTAL, WD, CLIP = 1e-3, 2, 10, 1e-3, 1.0


def _samples(pkg, n=3, seed=0):
    return pkg.SyntheticCrystals(n_samples=n, n_atoms=6, seed=seed).samples


def _batch(monkeypatch):
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    pb = tgraph.collate(_samples(tsynth), CUTOFF, MAX_NEIGHBORS, 24, 24 * MAX_NEIGHBORS,
                        fixed_degree=True)
    return pb, {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


def _jax_model(compute_dtype="float32"):
    return JaxMatPES(**CFG, fixed_degree=True, uniform_blocks=True, wigner_rep="dense",
                     remat=False, alpha_drop=0.0, drop_path_rate=0.0,
                     compute_dtype=compute_dtype)


def _random_flax_params(jm, batch, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _port_model(params, compute_dtype=torch.float32):
    model = EquiformerV2MatPES(**CFG, alpha_drop=0.0, drop_path_rate=0.0,
                               compute_dtype=compute_dtype)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k] ** 2)) for k in want)
    return (num / den) ** 0.5


def _port_grads(model, batch, mixed):
    model.zero_grad(set_to_none=True)
    params = cast_params(model, torch.bfloat16) if mixed else None
    outs = matpes_energy_forces(model, batch, create_graph=True, params=params)
    loss, metrics = matpes_loss(outs, batch)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().clone()
             for n, p in model.named_parameters()}
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


def _jax_grads(jm, params, batch, mixed):
    def loss_fn(p):
        if mixed:
            p = jtrainer.cast_params(p, jnp.bfloat16)
        outs = matpes_energy_forces_stress(jm, p, batch, regress_stress=False)
        return jtrainer.matpes_loss(outs, batch)

    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, flax_to_state_dict(grads)


def test_warmup_cosine_matches_jax():
    j, t = jsched.warmup_cosine(2e-4, 100, 10000), tsched.warmup_cosine(2e-4, 100, 10000)
    for s in (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 12000):
        # JAX evaluates in float32: 1e-7 of the base rate is its resolution
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6, atol=1e-7 * 2e-4)


def _adam_states(opt_state):
    inner = opt_state.inner_state[1]
    adam = next(s for s in inner if isinstance(s, optax.ScaleByAdamState))
    sched = next(s for s in inner if isinstance(s, optax.ScaleByScheduleState))
    return adam, sched


def test_guarded_adamw_matches_optax_on_identical_gradients():
    """5 steps: small, clipped (|g| >> 1), NaN (skipped: state frozen),
    and two after it; parameters, moments, learning rates and the guard's
    counters against the JAX package's make_optimizer."""
    rng = np.random.default_rng(0)
    names = {"dense.weight": ("dense", "kernel"), "dense.bias": ("dense", "bias"),
             "embed.weight": ("embed", "weight"), "so3.weight": ("so3", "weight")}
    shapes = {"dense.weight": (4, 3), "dense.bias": (4,), "embed.weight": (5, 3),
              "so3.weight": (2, 3, 4)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    scales = [0.01, 50.0, np.nan, 0.1, 0.02]
    grads = [{k: (rng.normal(size=s) * c).astype(np.float32) for k, s in shapes.items()}
             for c in scales]

    def tree(d):
        out = {}
        for k, (m, leaf) in names.items():
            out.setdefault(m, {})[leaf] = jnp.asarray(d[k])
        return out

    sched_j = jsched.warmup_cosine(LR, WARMUP, TOTAL)
    tx = jtrainer.make_optimizer(sched_j, WD, CLIP)
    jp = tree(init)
    js = tx.init(jp)
    tparams = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in init.items()}
    opt = GuardedAdamW(tparams.items(), tsched.warmup_cosine(LR, WARMUP, TOTAL), WD, CLIP)
    for g in grads:
        _, sched_before = _adam_states(js)
        lr_j = float(sched_j(sched_before.count))
        upd, js = tx.update(tree(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tparams.items():
            p.grad = torch.as_tensor(g[k])
        info = opt.step()
        adam, sched = _adam_states(js)
        assert info["accepted"] == bool(js.last_finite)
        np.testing.assert_allclose(info["lr"], lr_j, rtol=1e-6)
        assert opt.count == int(sched.count) == int(adam.count)
        assert opt.notfinite_count == int(js.notfinite_count)
        assert opt.total_notfinite == int(js.total_notfinite)
        assert opt.last_finite == bool(js.last_finite)
        for k, (m, leaf) in names.items():
            p = tparams[k]
            st = opt.opt.state.get(p, {})
            pairs = [(p.detach(), jp[m][leaf])]
            if int(adam.count):
                pairs += [(st["exp_avg"], adam.mu[m][leaf]),
                          (st["exp_avg_sq"], adam.nu[m][leaf])]
            for got, want in pairs:
                # 1e-6 of the tensor's scale: float32 rounds the two update
                # formulas (decoupled decay first, or added to the Adam term)
                # differently, by a few ulp of the largest entries
                want = np.asarray(want)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-6 * np.abs(want).max(), err_msg=k)
    assert opt.total_notfinite == 1 and opt.count == 4


def test_weight_decay_mask_matches_jax(monkeypatch):
    """The port's decayed parameters are exactly those JAX's _wd_mask marks."""
    _, jb, _ = _batch(monkeypatch)
    jm = _jax_model()
    params = _random_flax_params(jm, jb)
    mask = flatten(jtrainer._wd_mask(params)["params"])
    want = {port_name(path) for path, m in mask.items() if bool(m)}
    got = {n for n, m in wd_mask(_port_model(params)).items() if m}
    assert got == want
    assert len(got) > 10 and len(got) < len(mask)


@pytest.mark.parametrize("mixed", [False, True], ids=["f32", "bf16"])
def test_loss_and_gradients_match_jax(monkeypatch, mixed):
    """Loss, metrics and parameter gradients of the force loss (forces by
    autograd, loss backward a grad-of-grad) against the JAX package's."""
    _, jb, tb = _batch(monkeypatch)
    jm = _jax_model("bfloat16" if mixed else "float32")
    params = _random_flax_params(jm, jb)
    with flags.override(wigner="dense"):
        loss_j, met_j, grads_j = _jax_grads(jm, params, jb, mixed)
    model = _port_model(params, torch.bfloat16 if mixed else torch.float32)
    loss_t, met_t, grads_t = _port_grads(model, tb, mixed)
    rtol_loss, tol_grad = (2e-2, 5e-2) if mixed else (1e-5, 1e-4)
    np.testing.assert_allclose(loss_t, loss_j, rtol=rtol_loss)
    for k in met_j:
        np.testing.assert_allclose(met_t[k], met_j[k], rtol=rtol_loss, err_msg=k)
    assert grads_t.keys() == grads_j.keys()
    err = _rel_l2(grads_t, grads_j)
    print(f"{'bf16' if mixed else 'f32'}: loss rel err {abs(loss_t - loss_j) / abs(loss_j):.2e}, "
          f"gradient rel L2 err {err:.2e}")  # shown by pytest -s
    assert err <= tol_grad, err


def test_two_steps_match_make_matpes_train_step(monkeypatch):
    """Two whole float32 steps (guarded AdamW + EMA) against the JAX step."""
    _, jb, tb = _batch(monkeypatch)
    jm = _jax_model()
    params = _random_flax_params(jm, jb)
    sched_j = jsched.warmup_cosine(LR, WARMUP, TOTAL)
    tx = jtrainer.make_optimizer(sched_j, WD, CLIP)
    jstate = jtrainer.create_train_state(params, tx)
    with flags.override(wigner="dense"):
        jstep = jax.jit(jtrainer.make_matpes_train_step(jm, tx, ema_decay=0.9))
        jm_out = []
        for i in range(2):
            jstate, m = jstep(jstate, jb, jax.random.PRNGKey(i))
            jm_out.append({k: float(v) for k, v in m.items()})

    model = _port_model(params)
    opt = GuardedAdamW(model.named_parameters(), tsched.warmup_cosine(LR, WARMUP, TOTAL),
                       WD, CLIP)
    state = create_train_state(model, opt)
    step = make_matpes_train_step(state, ema_decay=0.9)
    for i in range(2):
        loss, m = step(tb)
        for k in ("loss", "energy_l1", "force_l1"):
            np.testing.assert_allclose(float(m[k]), jm_out[i][k], rtol=1e-5, err_msg=k)
        assert m["accepted"]
    assert state.step == 2 and opt.count == 2
    atol = 1e-2 * LR
    want_p, want_e = flax_to_state_dict(jstate.params), flax_to_state_dict(jstate.ema_params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(state.ema[k].numpy(), want_e[k].numpy(), rtol=0,
                                   atol=atol, err_msg=k)


def test_dropouts_eval_identity_whole_graphs_shared_channels():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 9, 64)
    gidx = torch.arange(4000) // 40          # 100 graphs of 40 nodes
    dp, ed = GraphDropPath(0.3), EquivariantDropout(0.3)
    dp.eval(), ed.eval()
    assert torch.equal(dp(x, gidx, 100, gen), x) and torch.equal(ed(x, gen), x)
    dp.train(), ed.train()
    y = dp(x, gidx, 100, gen)
    per_graph = y.reshape(100, -1)
    assert torch.all(per_graph.amin(1) == per_graph.amax(1))   # whole graphs
    assert set(torch.unique(y).tolist()) == {0.0, float(torch.tensor(1.0) / 0.7)}
    z = ed(x, gen)
    assert torch.all(z.amin(1) == z.amax(1))                   # shared over K
    n = 4000 * 64
    assert abs(float(z.mean()) - 1.0) < 4 * (0.3 / 0.7 / n) ** 0.5
    assert abs(float(per_graph[:, 0].mean()) - 1.0) < 4 * (0.3 / 0.7 / 100) ** 0.5
    # the same generator seed gives the same masks
    a = ed(x, torch.Generator().manual_seed(5))
    assert torch.equal(a, ed(x, torch.Generator().manual_seed(5)))


def test_model_dropout_only_in_train_mode(monkeypatch):
    _, _, tb = _batch(monkeypatch)
    model = init_weights(EquiformerV2MatPES(**CFG, alpha_drop=0.5, drop_path_rate=0.5,
                                            proj_drop=0.5), torch.Generator().manual_seed(0))
    model.eval()
    e0 = model(tb)["energy"]
    assert torch.equal(e0, model(tb, generator=torch.Generator().manual_seed(1))["energy"])
    model.train()
    e1 = model(tb, generator=torch.Generator().manual_seed(1))["energy"]
    e2 = model(tb, generator=torch.Generator().manual_seed(1))["energy"]
    assert torch.equal(e1, e2) and not torch.allclose(e1, e0)


def test_collate_labels_synthetic_and_loader_match_jax(monkeypatch):
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    ts, js = _samples(tsynth, n=10, seed=3), _samples(jsynth, n=10, seed=3)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.forces, b.forces)
        assert a.energy == b.energy
    n_pad, e_pad = tloader.infer_pad_sizes(ts, CUTOFF, MAX_NEIGHBORS, 4, uniform=True,
                                           fixed_degree=True)
    assert (n_pad, e_pad) == jloader.infer_pad_sizes(js, CUTOFF, MAX_NEIGHBORS, 4,
                                                     uniform=True, fixed_degree=True)
    tl = tloader.PaddedLoader(ts, 4, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, shuffle=True,
                              seed=7, prefetch=1, uniform=True, fixed_degree=True)
    jl = jloader.PaddedLoader(js, 4, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, shuffle=True,
                              seed=7, prefetch=0, uniform=True, fixed_degree=True)
    for loader in (tl, jl):
        loader.set_epoch(2)
    batches = list(zip(tl, jl))
    assert len(batches) == len(tl) == 2
    for a, b in batches:
        a, b = a.asdict(), b.asdict()
        assert a.keys() == b.keys() and {"energy", "forces", "stress"} <= a.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tl.overflow_batches == jl.overflow_batches == 0


def test_cli_trains_on_the_cpu_and_resumes(tmp_path):
    tiny = dict(CFG, max_train=8, max_val=4, batch_size=4, epochs=1,
                max_neighbors=MAX_NEIGHBORS, run_dir=str(tmp_path / "run"))
    argv = ["--config", "synthetic", "--device", "cpu"]
    state = train_matpes.main(argv, tiny)
    assert state.step == 2 and state.optimizer.count == 2
    ckpt = CheckpointManager(tiny["run_dir"])
    assert ckpt.latest_name() == "ckpt_epoch_00000"
    for f in ("ckpt_best.pt", "ckpt_best.meta.json", "losses.csv", "metrics.json"):
        assert (tmp_path / "run" / f).is_file(), f
    resumed = train_matpes.main(argv + ["--checkpoint", "ckpt_epoch_00000"], tiny)
    assert resumed.step == 4 and resumed.optimizer.count == 4
    # the round trip: a fresh state restored from the checkpoint equals the saved one
    fresh = train_matpes.build_model({**train_matpes.CONFIGS["synthetic"], **tiny}, False)
    opt = GuardedAdamW(fresh.named_parameters(), lambda s: 1e-3)
    back = create_train_state(fresh, opt)
    meta = ckpt.restore("ckpt_epoch_00000", back)
    assert meta["epoch"] == 0 and back.step == 4 and opt.count == 4
    for k, p in resumed.model.named_parameters():
        torch.testing.assert_close(dict(fresh.named_parameters())[k], p, rtol=0, atol=0)
        torch.testing.assert_close(back.ema[k], resumed.ema[k], rtol=0, atol=0)
