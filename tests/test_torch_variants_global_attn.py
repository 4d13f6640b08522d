"""The four global-attention classes: the port against the JAX package on
the CPU, in both layouts.

Each class runs on the nodes of a fixed-degree batch of three periodic
structures (4, 6 and 5 atoms in 8 slots each, so with padding nodes), in
the flat layout (the padded node axis with a same-graph pair mask) and the
dense one (per-graph packing by ``node_slot``, n_max 8), with the same
random params (Flax's, converted by utils/convert.py).  Output and the
gradients of a random cotangent by the features, the positions and every
parameter are held to 1e-5 (relative to the largest value; the parameter
gradients relative L2).  The positions' gradient is zero on both sides:
both detach the geometry at the same places.  The flat and the dense
layout agree with each other too.

The attention-weight ``dropout`` field: at 0 a training forward is the
evaluation forward bit for bit and draws nothing; with dropout > 0 the
evaluation forward still matches JAX's (deterministic) module at the same
limit; a training forward equals the same module's plain computation with
each softmax's weights multiplied by the mask replayed from the
generator's seed and scaled by 1 / (1 - dropout).  Flax draws its masks
from its own RNG streams, so the training masks themselves cannot be
matched bit for bit against JAX.
"""

import jax
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.nn import global_attn as jga
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import global_attn as tga

import torch_variant_helpers as h

C, LMAX, HEADS, N_MAX = 8, 2, 2, 8
K = (LMAX + 1) ** 2

CLASSES = {
    "scalar": (lambda **kw: jga.GlobalScalarAttention(C, HEADS, **kw),
               lambda **kw: tga.GlobalScalarAttention(C, HEADS, **kw), (C,)),
    "full": (lambda **kw: jga.GlobalFullAttention(C, K, HEADS, **kw),
             lambda **kw: tga.GlobalFullAttention(C, K, HEADS, **kw), (K, C)),
    "full_equivariant": (
        lambda **kw: jga.GlobalFullEquivariantAttention(C, LMAX, HEADS, **kw),
        lambda **kw: tga.GlobalFullEquivariantAttention(C, LMAX, HEADS, **kw), (K, C)),
    "htr_rope": (lambda **kw: jga.GlobalHTRAttention(C, LMAX, HEADS, use_rope=True, **kw),
                 lambda **kw: tga.GlobalHTRAttention(C, LMAX, HEADS, use_rope=True, **kw),
                 (K, C)),
    "htr_distance": (
        lambda **kw: jga.GlobalHTRAttention(C, LMAX, HEADS, use_distance=True, **kw),
        lambda **kw: tga.GlobalHTRAttention(C, LMAX, HEADS, use_distance=True, **kw), (K, C)),
}


def _inputs(kind):
    jb, tb = h.batches(seed=5)
    x = np.random.default_rng(6).normal(size=(jb["pos"].shape[0],) + CLASSES[kind][2])
    return jb, tb, x.astype(np.float32), np.asarray(jb["pos"])


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("kind", list(CLASSES))
def test_global_attention_matches_jax(kind, dense):
    _check_against_jax(kind, dense, {})


def _check_against_jax(kind, dense, kw):
    """The port's module (``kw``, in eval mode) against the JAX module's
    deterministic apply."""
    jb, tb, x, pos = _inputs(kind)
    jm, tm = CLASSES[kind][0](**kw), CLASSES[kind][1](**kw).eval()
    equivariant = kind == "full_equivariant"   # takes no positions
    jkw = dict(node_slot=jb["node_slot"], n_max=N_MAX, num_graphs=3) if dense else {}
    tkw = dict(node_slot=tb["node_slot"], n_max=N_MAX, num_graphs=3) if dense else {}
    gm, nm = jb["graph_idx"], jb["node_mask"]

    def jfn(p, a, q):
        if equivariant:
            return jm.apply(p, a, gm, nm, **jkw)
        return jm.apply(p, a, gm, nm, q, **jkw)

    params = h.random_like_tree(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x, gm, nm, *(() if equivariant else (pos,)))))
    errs = h.module_errors(jfn, params, tm,
                           lambda a, q: tm(a, tb["graph_idx"], tb["node_mask"], q, **tkw),
                           [x, pos])
    print(kind, "dense" if dense else "flat", errs)
    assert all(v <= 1e-5 for v in errs.values()), errs


@pytest.mark.parametrize("kind", list(CLASSES))
def test_flat_and_dense_layouts_agree(kind):
    _, tb, x, pos = _inputs(kind)
    tm = CLASSES[kind][1]()
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        init_weights,
    )
    init_weights(tm, torch.Generator().manual_seed(0))
    args = (torch.as_tensor(x), tb["graph_idx"], tb["node_mask"], torch.as_tensor(pos))
    with torch.no_grad():
        flat = tm(*args)
        dense = tm(*args, node_slot=tb["node_slot"], n_max=N_MAX, num_graphs=3)
    m = tb["node_mask"].numpy()
    assert h.rel(dense.numpy()[m], flat.numpy()[m]) <= 1e-5


def _args(kind):
    _, tb, x, pos = _inputs(kind)
    return (torch.as_tensor(x), tb["graph_idx"], tb["node_mask"], torch.as_tensor(pos))


def _seeded(tm):
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        init_weights,
    )
    return init_weights(tm, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", list(CLASSES))
def test_dropout_0_changes_nothing(kind):
    """At dropout 0 a training forward with a generator is the evaluation
    forward bit for bit, and the generator is not drawn from."""
    tm = _seeded(CLASSES[kind][1](dropout=0.0))
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with torch.no_grad():
        trained = tm.train()(*_args(kind), generator=gen)
        evaluated = tm.eval()(*_args(kind))
    assert torch.equal(trained, evaluated)
    assert torch.equal(gen.get_state(), state)


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("kind", list(CLASSES))
def test_dropout_in_eval_matches_jax(kind, dense):
    """With dropout 0.3, the evaluation forward (JAX: deterministic) matches
    the JAX module at the limits of test_global_attention_matches_jax."""
    _check_against_jax(kind, dense, dict(dropout=0.3))


@pytest.mark.parametrize("kind", list(CLASSES))
def test_dropout_in_training_is_the_masked_computation(kind, monkeypatch):
    """A training forward with dropout 0.3 equals the evaluation forward in
    which each softmax's weights are multiplied by the mask the generator
    draws (``torch.rand(shape) < 0.7``, in the order of the softmaxes) and
    scaled by 1 / 0.7, to the bit."""
    rate, keep = 0.3, 0.7
    tm = _seeded(CLASSES[kind][1](dropout=rate))
    with torch.no_grad():
        got = tm.train()(*_args(kind), generator=torch.Generator().manual_seed(4))
        plain = tm.eval()(*_args(kind))
        replay = torch.Generator().manual_seed(4)
        softmax = tga._masked_softmax

        def masked(logits, mask):
            w = softmax(logits, mask)
            return w * (torch.rand(w.shape, generator=replay) < keep).to(w.dtype) / keep

        monkeypatch.setattr(tga, "_masked_softmax", masked)
        want = tm(*_args(kind))
    assert torch.equal(got, want)
    assert not torch.equal(got, plain)
