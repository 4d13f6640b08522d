"""Rematerialization (the port's nn/remat.py, the backbone's ``remat`` and
the MatPES step's ``inner_ckpt``) against plain autograd, the port's own
step without it and the JAX package's step with it.

* The helper on a toy residual stack in float64: forces (a first
  derivative kept as a graph), the gradients of a loss of forces and
  energy (grad-of-grad), a first derivative without a graph, and a third
  derivative (``gradgradcheck``) equal plain autograd to 1e-12, with
  dropout masks drawn from a generator (or the default one) and replayed
  in every recompute; the generator ends where it ends without remat.
  Without grad the helper is a plain call.  The loss's backward may reach
  the call's two nodes in either order (the force pass on another thread):
  plain autograd's gradients bit for bit either way.
* Saved tensors (``torch.autograd.graph.saved_tensors_hooks``): between
  the force pass and the loss's backward a remat'd block keeps its inputs,
  the cotangents of its outputs and its parameters, and nothing else; the
  same block without remat keeps more.
* The float32 MatPES step (2 layers, lmax 2 / mmax 1, 16 channels, as
  tests/test_torch_train.py) with ``remat=True`` against the JAX model's
  ``remat=True`` step, and with ``inner_ckpt`` against the JAX package's
  ``inner_ckpt=True`` step: loss and metrics 1e-5 relative, gradients 1e-4
  relative L2 (tests/test_torch_train.py's limits).
* Against the port's own step without remat, dropouts and stress on
  (alpha_drop 0.3, drop_path 0.3, proj_drop 0.2, w_stress 0.1): loss and
  gradients within 1e-6 relative (L2), and on the CPU bit for bit (the
  remat'd step sums each gradient in the same order), in float32 and in
  bfloat16; the dropout generator's state equal after the step, and the
  MoE's routing entropies as the plain forward leaves them.
* The QM9 and OC20 models with ``remat`` (first order; OC20 on the
  factored Wigner): dropouts on, the same gradients bit for bit.
* The composite step at model = 2 (dropout on) with remat and with
  ``inner_ckpt``, and the pipelined step at pipe = 2 with remat, against
  the same steps without (2 gloo ranks, tests/torch_remat_helpers.py):
  loss 1e-6 relative, gathered gradients, masters and EMA 1e-6 relative L2.
* The MatPES CLI runs the recompute when its config sets ``remat`` and
  ``inner_ckpt``, and refuses ``inner_ckpt`` with ``pipe``.
"""

import gc
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_helpers as H
import torch_remat_helpers as R
import torch_sharding_helpers as S
import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import synthetic as tsynth
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models import backbone
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models import matpes as tmatpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
    matpes_energy_forces,
    routing_entropies,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.oc20 import (
    EquiformerV2OC20,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.qm9 import EquiformerV2QM9
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import remat
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import train_matpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    create_train_state,
    matpes_loss,
    matpes_loss_grad,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

CFG = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=2, mmax=1, grid_resolution=None, edge_channels=16, num_rbf=32,
           cutoff=5.0)
LAYOUT = dict(fixed_degree=True, uniform_blocks=True)
DROPOUTS = dict(alpha_drop=0.3, drop_path_rate=0.3, proj_drop=0.2)
CUTOFF, MAX_NEIGHBORS = 5.0, 8


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ── the helper on a toy stack ───────────────────────────────────────────────

def _toy_block(x, p, gen):
    """A residual block with a dropout mask drawn from ``gen``."""
    h = torch.tanh(x @ p["w"]) * torch.sin(x @ p["v"])
    keep = torch.rand(h.shape, generator=gen, dtype=h.dtype) > 0.3
    return (x + h * keep / 0.7, h.sum(-1))


def _toy_run(use_remat: bool, create_graph: bool, default_generator: bool):
    """Forces of a 4-block toy energy, then the gradients of a loss of
    forces and energy (when ``create_graph``); the generator's state after."""
    g = torch.Generator().manual_seed(0)
    ws = [{k: (torch.randn(8, 8, generator=g, dtype=torch.float64) * 0.4).requires_grad_(True)
           for k in ("w", "v")} for _ in range(4)]
    pos = torch.randn(12, 3, generator=g, dtype=torch.float64).requires_grad_(True)
    proj = torch.randn(3, 8, generator=g, dtype=torch.float64)
    torch.manual_seed(7)
    gen = None if default_generator else torch.Generator().manual_seed(5)
    x, energy = pos @ proj, 0.0
    for p in ws:
        if use_remat:
            x, s = remat.remat_call(_toy_block, (x,), p, gen)
        else:
            x, s = _toy_block(x, p, gen if gen is not None else torch.default_generator)
        energy = energy + (s ** 2).sum()
    energy = energy + (x ** 2).sum()
    (forces,) = torch.autograd.grad(energy, pos, create_graph=create_graph)
    out = {"forces": forces.detach()}
    if create_graph:
        ((forces ** 2).sum() + energy).backward()
        out.update({f"{i}{k}": p[k].grad for i, p in enumerate(ws) for k in p})
        out["pos"] = pos.grad
    state = torch.default_generator.get_state() if gen is None else gen.get_state()
    return out, state


@pytest.mark.parametrize("default_generator", [False, True], ids=["generator", "default"])
@pytest.mark.parametrize("create_graph", [True, False], ids=["grad_of_grad", "first_order"])
def test_helper_matches_plain_autograd(create_graph, default_generator):
    want, want_state = _toy_run(False, create_graph, default_generator)
    got, got_state = _toy_run(True, create_graph, default_generator)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-12, atol=1e-12, msg=k)
    assert torch.equal(got_state, want_state)


@pytest.mark.parametrize("force_thread", [False, True], ids=["vjp_first", "remat_first"])
def test_helper_hands_off_in_either_order(force_thread):
    """The loss's backward reaches the call's _RematVJP node first when the
    force pass ran on this thread, and its _Remat node first when the force
    pass ran on another (autograd orders ready nodes by per-thread sequence
    numbers, as the card's autograd thread makes the force pass's nodes):
    either way the gradients are plain autograd's, bit for bit."""
    g = torch.Generator().manual_seed(2)
    w = (torch.randn(8, 8, generator=g, dtype=torch.float64) * 0.4).requires_grad_(True)
    x0 = torch.randn(12, 8, generator=g, dtype=torch.float64)

    def energy(x, p, gen):
        return ((torch.tanh(x @ p["w"]) ** 2).sum(),)

    out = []
    for use_remat in (False, True):
        w.grad = None
        x = x0.clone().requires_grad_(True)
        (e,) = remat.remat_call(energy, (x,), {"w": w}) if use_remat else energy(x, {"w": w}, None)
        forces = []

        def force_pass():
            forces.append(torch.autograd.grad(e, x, create_graph=True)[0])

        if use_remat and force_thread:
            t = threading.Thread(target=force_pass)
            t.start()
            t.join(60)
        else:
            force_pass()
        ((forces[0] ** 2).sum() + e).backward()
        out.append((w.grad.clone(), x.grad.clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_helper_third_derivative_and_plain_call_without_grad():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(5, 5, generator=g, dtype=torch.float64, requires_grad=True)

    def f(x, w):
        return remat.remat_call(lambda x, p, gen: (torch.sin(x @ p["w"]) * x,), (x,),
                                {"w": w})[0]

    assert torch.autograd.gradgradcheck(f, (x, w))
    with torch.no_grad():
        assert f(x, w).grad_fn is None
    assert type(f(x, w).grad_fn).__name__ == "_RematBackward"


# ── what a remat'd block keeps ──────────────────────────────────────────────

def _batch(monkeypatch, stress: bool = False):
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    samples = tsynth.SyntheticCrystals(n_samples=3, n_atoms=6, seed=0).samples
    if stress:
        rng = np.random.default_rng(0)
        for s in samples:
            s.stress = rng.normal(size=6).astype(np.float32)
    pb = tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, 24, 24 * MAX_NEIGHBORS,
                        fixed_degree=True)
    return pb, {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


class _Held:
    """A saved tensor, weakly referable: alive while a graph holds it (kept
    detached: a saved output holding its own node would be a cycle that
    outlives the graph)."""

    def __init__(self, t):
        self.t = t.detach()


@pytest.mark.parametrize("use_remat", [True, False], ids=["remat", "plain"])
def test_saved_tensors_between_force_pass_and_loss_backward(monkeypatch, use_remat):
    """One block of the model, its inputs from the pre-stack (detached):
    a linear energy of its outputs, the forces by its inputs with a graph;
    then every tensor a graph still holds must be an input of the block,
    a parameter, an energy weight or a cotangent of the block's outputs."""
    _, _, tb = _batch(monkeypatch)
    model = init_weights(EquiformerV2MatPES(**CFG, **LAYOUT, alpha_drop=0.0,
                                            drop_path_rate=0.0),
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        (x, t_ij, _), bc = model(tb, stack_capture=True)
    x, t_ij = x.requires_grad_(True), t_ij.requires_grad_(True)
    blk = model.backbone.blocks[0]
    gen = torch.Generator().manual_seed(2)
    c_x, c_t = torch.randn(x.shape, generator=gen), torch.randn(t_ij.shape, generator=gen)
    cots = []
    held = weakref.WeakSet()

    def pack(t):
        h = _Held(t)
        held.add(h)
        return h

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
        out = backbone.block_step(blk, (x, t_ij, None), bc, 3, remat=use_remat)
        for o in out[:2]:
            o.register_hook(lambda g: cots.append(g))
        energy = (out[0] * c_x).sum() + (out[1] * c_t).sum()
        fx, ft = torch.autograd.grad(energy, (x, t_ij), create_graph=True)
    gc.collect()
    allowed = [x, t_ij, c_x, c_t, *cots, *blk.parameters(),
               *(v for v in bc if isinstance(v, torch.Tensor)),
               *(v for v in vars(bc.wigner).values() if isinstance(v, torch.Tensor))]
    ptrs = {t.untyped_storage().data_ptr() for t in allowed}
    kept = [h.t for h in held]
    foreign = [tuple(t.shape) for t in kept if t.untyped_storage().data_ptr() not in ptrs]
    print(f"{'remat' if use_remat else 'plain'}: {len(kept)} saved tensors held, "
          f"{len(foreign)} not inputs / parameters / cotangents")   # pytest -s
    if use_remat:
        assert kept and not foreign, foreign
        assert any(t.untyped_storage().data_ptr() in {c.untyped_storage().data_ptr()
                                                      for c in cots} for t in kept)
    else:
        assert len(foreign) > 20
    ((fx ** 2).sum() + (ft ** 2).sum()).backward()   # the loss's backward still runs
    assert sum(p.grad is not None for p in blk.parameters()) > 10


# ── the MatPES step against JAX ─────────────────────────────────────────────

def _random_flax_params(jm, batch, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))
    return jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2] if len(s.shape) >= 2 else 4)
                   ).astype(np.float32), shapes)


@pytest.mark.parametrize("mode", ["remat", "inner_ckpt"])
def test_f32_step_matches_jax(monkeypatch, mode):
    """The force loss and its gradients: the port's ``remat=True`` model
    against the JAX model's, and the port's ``inner_ckpt`` against the JAX
    package's ``inner_ckpt=True`` (jax.checkpoint of the energy function)."""
    _, jb, tb = _batch(monkeypatch)
    use_remat, inner = mode == "remat", mode == "inner_ckpt"
    jm = JaxMatPES(**CFG, **LAYOUT, wigner_rep="dense", remat=use_remat, alpha_drop=0.0,
                   drop_path_rate=0.0)
    params = _random_flax_params(jm, jb)

    def loss_fn(p):
        outs = matpes_energy_forces_stress(jm, p, jb, regress_stress=False, inner_ckpt=inner)
        return jtrainer.matpes_loss(outs, jb)

    with flags.override(wigner="dense"):
        (loss_j, met_j), grads_j = V.run_jax(jax.value_and_grad(loss_fn, has_aux=True), params)
    model = EquiformerV2MatPES(**CFG, alpha_drop=0.0, drop_path_rate=0.0, remat=use_remat)
    model.load_state_dict(flax_to_state_dict(params))
    outs = matpes_energy_forces(model, tb, create_graph=True, inner_ckpt=inner)
    loss_t, met_t = matpes_loss(outs, tb)
    loss_t.backward()
    grads_t = {n: p.grad if p.grad is not None else torch.zeros_like(p)
               for n, p in model.named_parameters()}
    grads_j = flax_to_state_dict(grads_j)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    for k in met_j:
        np.testing.assert_allclose(float(met_t[k].detach()), float(met_j[k]), rtol=1e-5,
                                   err_msg=k)
    assert grads_t.keys() == grads_j.keys()
    err = V.rel_l2(grads_t, grads_j)
    print(f"{mode}: gradient rel L2 err {err:.2e}")   # pytest -s
    assert err <= 1e-4, err


# ── against the port's own step without remat ───────────────────────────────

STEP_MODES = {"remat": (True, False, {}), "inner_ckpt": (False, True, {}),
              "both": (True, True, {}),
              "moe_remat": (True, False, dict(ffn_variant="moe", num_experts=4)),
              "bf16_remat": (True, False, dict(compute_dtype=torch.bfloat16))}


def _loss_grad(tb, use_remat: bool, inner: bool, kw: dict):
    model = init_weights(EquiformerV2MatPES(**CFG, **LAYOUT, **DROPOUTS, remat=use_remat, **kw),
                         torch.Generator().manual_seed(0))
    state = create_train_state(model, GuardedAdamW(model.named_parameters(), lambda s: 1e-3))
    gen = torch.Generator().manual_seed(4)
    loss, metrics = matpes_loss_grad(state, w_stress=0.1, generator=gen, inner_ckpt=inner)(tb)
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return float(loss), metrics, grads, gen.get_state(), routing_entropies(model)


@pytest.mark.parametrize("mode", list(STEP_MODES))
def test_step_matches_the_step_without_remat(monkeypatch, mode):
    """Dropouts and stress on: the same loss, gradients, generator state
    and MoE routing entropies as the step without remat."""
    _, _, tb = _batch(monkeypatch, stress=True)
    use_remat, inner, kw = STEP_MODES[mode]
    loss0, met0, grads0, gen0, ent0 = _loss_grad(tb, False, False, kw)
    loss1, met1, grads1, gen1, ent1 = _loss_grad(tb, use_remat, inner, kw)
    assert "stress_l1" in met1
    assert abs(loss1 / loss0 - 1) <= 1e-6
    assert grads1.keys() == grads0.keys()
    err = V.rel_l2(grads1, grads0)
    print(f"{mode}: loss rel err {abs(loss1 / loss0 - 1):.2e}, gradient rel L2 {err:.2e}")
    assert err <= 1e-6, err
    # on the CPU the sums take the same order as without remat: the same bits
    assert loss1 == loss0 and all(torch.equal(grads1[k], g) for k, g in grads0.items())
    assert torch.equal(gen1, gen0)
    assert len(ent1) == len(ent0) == (CFG["num_layers"] if "num_experts" in kw else 0)
    for a, b in zip(ent1, ent0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["qm9", "oc20"])
def test_first_order_models_with_remat(monkeypatch, kind):
    """The QM9 and OC20 models take ``remat`` too (one backward, first
    order; OC20 on the factored Wigner, whose cached tables the recompute
    shares): dropouts on, the loss's gradients bit for bit those without."""
    _, _, tb = _batch(monkeypatch)
    kw = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
              attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
              lmax=2, mmax=1, edge_channels=16, num_rbf=16, cutoff=5.0, **LAYOUT, **DROPOUTS)
    out = {}
    for use_remat in (False, True):
        model = (EquiformerV2QM9(num_targets=3, max_num_elements=100, remat=use_remat, **kw)
                 if kind == "qm9" else
                 EquiformerV2OC20(max_num_elements=100, remat=use_remat, **kw))
        init_weights(model, torch.Generator().manual_seed(0)).train()
        gen = torch.Generator().manual_seed(3)
        pred = model(tb, generator=gen)
        loss = (pred ** 2).mean() if kind == "qm9" else (
            (pred["energy"] ** 2).mean() + (pred["forces"] ** 2).mean())
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        out[use_remat] = (float(loss.detach()), grads, gen.get_state())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert l1 == l0 and g1.keys() == g0.keys() and torch.equal(s1, s0)
    assert all(torch.equal(g1[k], g) for k, g in g0.items())


# ── the parallel steps ──────────────────────────────────────────────────────

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The composite step at model = 2 (dropout on) plain, with remat and
    with inner_ckpt, and the pipelined step at pipe = 2 plain and with
    remat, on 2 gloo ranks: [rank 0's results, rank 1's]."""
    out = tmp_path_factory.mktemp("remat")
    base = S.case(2, False, cfg_kw=dict(alpha_drop=0.3, drop_path_rate=0.3))[0]
    composite = {"plain": base,
                 "remat": dict(base, cfg=dict(base["cfg"], remat=True)),
                 "inner_ckpt": dict(base, step_kw=dict(inner_ckpt=True))}
    pipe = dict(base, mesh=(1, 2), batches=[S.crystals(0), S.crystals(1)])
    pipelined = {"pipe plain": pipe, "pipe remat": dict(pipe, cfg=dict(pipe["cfg"], remat=True))}
    codes = H.spawn(R.remat_worker, 2, 2, H.free_port(), str(out), composite, pipelined, 1)
    assert codes == [0, 0], f"rank exit codes {codes}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("name,plain", [("remat", "plain"), ("inner_ckpt", "plain"),
                                        ("pipe remat", "pipe plain")])
def test_parallel_step_matches_the_step_without_remat(ranks, name, plain):
    for r in ranks:
        got, want = r[name], r[plain]
        assert abs(got["loss"] / want["loss"] - 1) <= 1e-6
        for part in ("grads", "params", "ema"):
            assert got[part].keys() == want[part].keys()
            err = V.rel_l2(got[part], want[part])
            assert err <= 1e-6, (part, err)


# ── the CLI ─────────────────────────────────────────────────────────────────

def test_cli_runs_the_recompute(tmp_path, monkeypatch):
    calls = {"block": 0, "energy": 0}

    def counting(kind, inner):
        def call(*args, **kwargs):
            calls[kind] += 1
            return inner(*args, **kwargs)
        return call

    monkeypatch.setattr(backbone, "remat_call", counting("block", remat.remat_call))
    monkeypatch.setattr(tmatpes, "remat_call", counting("energy", remat.remat_call))
    tiny = dict(CFG, max_train=8, max_val=4, batch_size=4, epochs=1,
                max_neighbors=MAX_NEIGHBORS, run_dir=str(tmp_path / "run"), remat=True,
                inner_ckpt=True)
    state = train_matpes.main(["--config", "synthetic", "--device", "cpu"], tiny)
    assert state.step == 2 and state.model.backbone.remat
    # the energy once a step; the blocks in the forward and the recomputes
    # (the evaluation's model has no remat)
    assert calls["energy"] == 2 and calls["block"] >= 2 * 2 * CFG["num_layers"], calls
    with pytest.raises(SystemExit, match="inner_ckpt"):
        train_matpes.main(["--config", "synthetic", "--device", "cpu", "--mesh",
                           "data=1,pipe=2"], tiny)
