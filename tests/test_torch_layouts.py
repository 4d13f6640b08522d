"""The ragged and graph-uniform edge layouts and the ``blocks`` Wigner
representation: the port against the JAX package on the CPU.

Inputs are made by numpy from a seed.  ``collate`` is held array for array
in each of the three layouts.  The segment ops are held against every JAX
path (scatter, one-hot matmul, sorted scan, graph-uniform blocks, fixed
degree) with masked entries and an empty segment, to the second
derivative: f32 1e-5 relative in values, 1e-4 in first and second
derivatives.  The deterministic gather / segment-sum pair gives the same
bits twice and equals ``index_select`` / ``index_add`` within f32 rounding
(1e-6 relative), to the second derivative.  The flagship-shaped MatPES
GATA-V2 model (2 layers, 16 channels, lmax 2 / mmax 1) runs ragged and
uniform: energies 1e-5 relative, forces and per-graph stress 1e-4 of their
largest entry, the force-training loss 1e-5 and its gradients (a
grad-of-grad through the force and strain derivatives) 1e-4 relative L2
against JAX on the same batch.  ``wigner_rep="blocks"`` is held against
``"dense"`` in the port and against JAX's ``blocks`` (MatPES and QM9) at
the same limits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
    matpes_energy_forces_stress_pergraph as jax_pergraph,
)
from equivarianttransformermpnn4quantumcomputations_tpu.models.qm9 import (
    EquiformerV2QM9 as JaxQM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu.ops import segment as jseg
from equivarianttransformermpnn4quantumcomputations_tpu.ops.pallas.segsum import (
    gather_nodes as jgather,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    matpes_energy_forces,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.qm9 import (
    EquiformerV2QM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import segment as tseg
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import matpes_loss
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

CFG = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=2, mmax=1, grid_resolution=None, edge_channels=16, num_rbf=32,
           max_num_elements=20, cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
CUTOFF, MAX_NEIGHBORS, W_STRESS = 5.0, 6, 0.1
# (collate flags, n_pad, e_pad) of three graphs of 4, 6 and 5 atoms
LAYOUTS = {"ragged": ({}, 24, 128), "uniform": (dict(uniform=True), 24, 144),
           "fixed_degree": (dict(fixed_degree=True), 24, 24 * MAX_NEIGHBORS)}


def _samples(seed=0, sizes=(4, 6, 5), molecule: bool = True):
    """Labelled crystals (stress too), the last a molecule without a cell."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(sizes):
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        pbc = not (molecule and i == len(sizes) - 1)
        out.append(dict(
            atomic_numbers=rng.integers(1, 10, size=n).astype(np.int32),
            pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32),
            cell=cell if pbc else None, pbc=pbc, energy=float(rng.normal()),
            forces=rng.normal(size=(n, 3)).astype(np.float32),
            stress=(rng.normal(size=6) * 0.05).astype(np.float32)))
    return out


def _collate(graph, samples, layout, **kw):
    flags_, n_pad, e_pad = LAYOUTS[layout]
    return graph.collate([graph.GraphSample(**s) for s in samples], CUTOFF, MAX_NEIGHBORS,
                         n_pad, e_pad, **flags_, **kw)


@pytest.mark.parametrize("layout,seed", [("ragged", 0), ("uniform", 0), ("fixed_degree", 0),
                                         ("ragged", 1), ("uniform", 1)])
def test_collate_matches_jax(monkeypatch, layout, seed):
    """Array for array, labels and overflow counters included; seed 1 packs
    12 atoms into 8-node slots (uniform) or a 24-node pad (ragged), so the
    truncation rules are held too."""
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    sizes = (4, 6, 5) if seed == 0 else (4, 12, 9)
    samples = _samples(seed, sizes)
    with pytest.warns(UserWarning) if seed else _nothing():
        a = _collate(tgraph, samples, layout)
    with pytest.warns(UserWarning) if seed else _nothing():
        b = _collate(jgraph, samples, layout)
    assert (a.overflow_atoms, a.overflow_edges) == (b.overflow_atoms, b.overflow_edges)
    assert bool(seed) == bool(a.overflow_atoms or a.overflow_edges)
    want = {k: v for k, v in b.asdict().items() if k != "fixed"}
    got = a.asdict()
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if layout == "ragged":   # real edges sorted by destination, padding 0 -> 0
        m = got["edge_mask"]
        assert np.all(np.diff(got["edge_dst"][m]) >= 0)
        assert not got["edge_src"][~m].any() and not got["edge_dst"][~m].any()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ── the segment ops ──────────────────────────────────────────────────────────

B, N_MAX, E_MAX, K = 3, 4, 8, 2     # blocked: 3 graphs of 4 node and 8 edge rows


def _segments(path: str, seed: int = 0):
    """(ids, mask, num_segments, JAX keyword arguments, port ``blocks``):
    ids sorted within each graph (the collate invariant); node 3 of graph
    1 has no real entry (an empty segment) and some entries are masked."""
    rng = np.random.default_rng(seed)
    N = B * N_MAX
    if path == "fixed":
        ids = np.repeat(np.arange(N), K)
        mask = rng.uniform(size=N * K) < 0.8
        mask[(N_MAX + 3) * K:(N_MAX + 4) * K] = False
        blocks = (B, N_MAX, N_MAX * K, K)
        return ids, mask, N, dict(blocks=blocks, fixed_dst=True), blocks
    ids = np.concatenate([np.sort(rng.integers(0, N_MAX, size=E_MAX)) + b * N_MAX
                          for b in range(B)])
    ids[ids == N_MAX + 3] = N_MAX + 2
    mask = rng.uniform(size=ids.size) < 0.8
    if path == "blocked":
        return ids, mask, N, dict(blocks=(B, N_MAX, E_MAX)), (B, N_MAX, E_MAX)
    kw = {"scatter": dict(method="scatter"), "matmul": dict(method="matmul"),
          "sorted": dict(sorted_ids=True), "default": {}, "segment_max": {}}[path]
    return ids, mask, N, kw, None


def _jax_op(op, ids, mask, n, kw):
    ids, mask = jnp.asarray(ids), jnp.asarray(mask)
    if op == "sum":
        return lambda v: jseg.segment_sum(v, ids, n, mask, **kw)
    if op == "mean":
        return lambda v: jseg.segment_mean(v, ids, n, mask, **kw)
    return lambda v: jseg.segment_softmax(v, ids, n, mask, **kw)


def _port_op(op, ids, mask, n, blocks):
    ids, mask = torch.as_tensor(ids), torch.as_tensor(mask)
    fixed = blocks is not None and len(blocks) > 3
    fn = {"sum": tseg.segment_sum, "mean": tseg.segment_mean,
          "softmax": tseg.segment_softmax}[op]
    return lambda v: fn(v, ids, n, mask, blocks=blocks, fixed_dst=fixed)


def _derivatives_jax(f, v, u, c):
    """(f(v), d<c, f(v)^2>/dv, d<u, that>/dv)."""
    g = jax.grad(lambda w: jnp.sum(c * f(w) ** 2))
    h = jax.grad(lambda w: jnp.vdot(g(w), u))
    return f(v), g(v), h(v)


def _derivatives_port(f, v, u, c):
    w = torch.tensor(v, requires_grad=True)
    out = f(w)
    (g,) = torch.autograd.grad((torch.as_tensor(c) * out ** 2).sum(), w, create_graph=True)
    (h,) = torch.autograd.grad((g * torch.as_tensor(u)).sum(), w)
    return out.detach(), g.detach(), h


@pytest.mark.parametrize("op,path", [
    ("sum", "scatter"), ("sum", "matmul"), ("sum", "blocked"), ("sum", "fixed"),
    ("mean", "default"), ("mean", "blocked"), ("mean", "fixed"),
    ("softmax", "segment_max"), ("softmax", "sorted"), ("softmax", "blocked"),
    ("softmax", "fixed")])
def test_segment_ops_match_every_jax_path(op, path):
    ids, mask, n, kw, blocks = _segments(path)
    rng = np.random.default_rng(1)
    shape = (ids.size, 3) if op == "softmax" else (ids.size, 2, 3)
    out_shape = shape if op == "softmax" else (n,) + shape[1:]
    v, u = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    c = rng.normal(size=out_shape).astype(np.float32)
    want = _derivatives_jax(_jax_op(op, ids, mask, n, kw), jnp.asarray(v), jnp.asarray(u),
                            jnp.asarray(c))
    got = _derivatives_port(_port_op(op, ids, mask, n, blocks), v, u, c)
    for what, g, w, tol in zip(("value", "first", "second"), got, want, (1e-5, 1e-4, 1e-4)):
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err <= tol, (what, err)
    if op != "sum":   # the empty segment gives zeros, never NaN
        assert np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize("path", ["ragged", "blocked", "fixed"])
def test_gather_nodes_matches_jax(path):
    """The node gather (``canonical_dst`` on the fixed-degree layout) and
    its transposes, to the second derivative."""
    ids, _, n, _, blocks = _segments({"ragged": "scatter"}.get(path, path))
    rng = np.random.default_rng(2)
    x, u = (rng.normal(size=(n, 2, 3)).astype(np.float32) for _ in range(2))
    c = rng.normal(size=(ids.size, 2, 3)).astype(np.float32)
    canon = path == "fixed"
    jb = blocks if blocks is None or canon else blocks[:3]
    want = _derivatives_jax(lambda w: jgather(w, jnp.asarray(ids), blocks=jb,
                                              canonical_dst=canon),
                            jnp.asarray(x), jnp.asarray(u), jnp.asarray(c))
    got = _derivatives_port(lambda w: tseg.gather_nodes(w, torch.as_tensor(ids), blocks,
                                                        canonical_dst=canon), x, u, c)
    for g, w, tol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=tol * float(np.abs(np.asarray(w)).max()))


@pytest.mark.parametrize("which", ["gather", "segment_sum"])
def test_deterministic_pair_repeats_and_equals_index_add(which):
    """The gather / segment-sum pair gives the same bits twice and equals
    index_select / index_add (autograd's own transposes) within f32
    rounding, to the second derivative."""
    rng = np.random.default_rng(3)
    n, E = 40, 400
    ids = torch.as_tensor(rng.integers(0, n, size=E))
    rows = n if which == "gather" else E
    x = rng.normal(size=(rows, 5, 4)).astype(np.float32)
    u = rng.normal(size=x.shape).astype(np.float32)
    c = rng.normal(size=((E if which == "gather" else n), 5, 4)).astype(np.float32)
    if which == "gather":
        mine = lambda w: tseg.gather_nodes(w, ids)                      # noqa: E731
        plain = lambda w: w.index_select(0, ids)                       # noqa: E731
    else:
        mine = lambda w: tseg.segment_sum(w, ids, n)                    # noqa: E731
        plain = lambda w: w.new_zeros((n,) + w.shape[1:]).index_add(0, ids, w)  # noqa: E731
    a, b, ref = (_derivatives_port(f, x, u, c) for f in (mine, mine, plain))
    for ga, gb, gr in zip(a, b, ref):
        assert torch.equal(ga, gb)
        torch.testing.assert_close(ga, gr, rtol=1e-6, atol=1e-6 * float(gr.abs().max()))


# ── the model in the ragged and uniform layouts ─────────────────────────────

def _jax_matpes(layout, **kw):
    return JaxMatPES(**CFG, uniform_blocks=layout != "ragged",
                     fixed_degree=layout == "fixed_degree", remat=False, **kw)


def _port_matpes(layout, params, **kw):
    model = EquiformerV2MatPES(**CFG, uniform_blocks=layout != "ragged",
                               fixed_degree=layout == "fixed_degree", **kw)
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model


def _matpes_errors(layout: str, seed: int, jax_kw: dict, port_kw: dict) -> dict:
    """Energies, forces and per-graph stress, and the force-training loss
    with stress and its parameter gradients: the port against JAX."""
    pb = _collate(tgraph, _samples(seed), layout)
    jb, tb = {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")
    jm = _jax_matpes(layout, **jax_kw)
    params = V.random_flax_params(jm, jb, seed + 1)

    def loss_fn(p):
        outs = jax_pergraph(jm, p, jb)
        return jtrainer.matpes_loss(outs, jb, 1.0, 1.0, W_STRESS)[0], outs

    with flags.override(wigner=jax_kw.get("wigner_rep", "dense")):
        (loss_j, outs_j), grads_j = V.run_jax(jax.value_and_grad(loss_fn, has_aux=True), params)
    grads_j = flax_to_state_dict(grads_j)
    model = _port_matpes(layout, params, **port_kw)
    outs = matpes_energy_forces(model, tb, create_graph=True, regress_stress=True)
    loss, _ = matpes_loss(outs, tb, 1.0, 1.0, W_STRESS)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.detach()
             for n, p in model.named_parameters()}
    assert grads.keys() == grads_j.keys()
    m = pb.node_mask
    return {"energy": V.rel(outs["energy"].detach().numpy(), outs_j["energy"]),
            "forces": V.rel(outs["forces"].detach().numpy()[m], np.asarray(outs_j["forces"])[m]),
            "stress": V.rel(outs["stress"].detach().numpy(), outs_j["stress"]),
            "loss": abs(float(loss.detach()) - float(loss_j)) / abs(float(loss_j)),
            "gradients": V.rel_l2(grads, grads_j)}


LIMITS = {"energy": 1e-5, "forces": 1e-4, "stress": 1e-4, "loss": 1e-5, "gradients": 1e-4}


@pytest.mark.parametrize("layout", ["ragged", "uniform"])
def test_flagship_shaped_matpes_matches_jax(layout):
    errs = _matpes_errors(layout, 0, dict(wigner_rep="dense"), {})
    print(f"GATA-V2 {layout}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert all(errs[k] <= LIMITS[k] for k in LIMITS), errs


def test_blocks_wigner_matches_jax_and_dense():
    """``wigner_rep="blocks"`` against JAX's blocks and the port's dense, ragged."""
    errs = _matpes_errors("ragged", 2, dict(wigner_rep="blocks"), dict(wigner_rep="blocks"))
    assert all(errs[k] <= LIMITS[k] for k in LIMITS), errs
    pb = _collate(tgraph, _samples(2), "ragged")
    tb = tgraph.as_tensors(pb, "cpu")
    sd = _port_matpes("ragged", V.random_flax_params(
        _jax_matpes("ragged"), {k: jnp.asarray(v) for k, v in pb.asdict().items()}, 5)
    ).state_dict()
    outs = {}
    for rep in ("dense", "blocks"):
        model = EquiformerV2MatPES(**CFG, wigner_rep=rep)
        model.load_state_dict(sd)
        o = matpes_energy_forces(model, tb)
        outs[rep] = (o["energy"].detach().numpy(), o["forces"].detach().numpy())
    assert V.rel(outs["blocks"][0], outs["dense"][0]) <= 1e-5
    assert V.rel(outs["blocks"][1], outs["dense"][1]) <= 1e-4


@pytest.mark.parametrize("layout", ["ragged", "fixed_degree"])
def test_qm9_blocks_wigner_matches_jax(layout):
    """``EquiformerV2QM9(wigner_rep="blocks")`` against JAX's, and the port's
    dense representation on the same weights (predictions 1e-5 relative)."""
    samples = [{**s, "pbc": False, "cell": None} for s in _samples(4)]
    pb = _collate(tgraph, [{k: v for k, v in s.items() if k not in ("energy", "forces",
                                                                      "stress")}
                           for s in samples], layout)
    jb, tb = {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")
    qcfg = {k: v for k, v in CFG.items() if k != "max_num_elements"}
    fixed = layout == "fixed_degree"
    jm = JaxQM9(**qcfg, num_targets=3, max_num_elements=10, fixed_degree=fixed,
                wigner_rep="blocks", remat=False)
    params = V.random_flax_params(jm, jb, 6)
    with flags.override(wigner="blocks"):
        want = np.asarray(V.run_jax(lambda p, b: jm.apply(p, b), params, jb))
    got = {}
    for rep in ("blocks", "dense"):
        model = EquiformerV2QM9(**qcfg, num_targets=3, max_num_elements=10, fixed_degree=fixed,
                                wigner_rep=rep)
        model.load_state_dict(flax_to_state_dict(params), strict=True)
        with torch.no_grad():
            got[rep] = model.eval()(tb).numpy()
    assert V.rel(got["blocks"], want) <= 1e-5
    assert V.rel(got["dense"], got["blocks"]) <= 1e-5

