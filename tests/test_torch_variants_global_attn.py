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
    "scalar": (lambda: jga.GlobalScalarAttention(C, HEADS),
               lambda: tga.GlobalScalarAttention(C, HEADS), (C,)),
    "full": (lambda: jga.GlobalFullAttention(C, K, HEADS),
             lambda: tga.GlobalFullAttention(C, K, HEADS), (K, C)),
    "full_equivariant": (lambda: jga.GlobalFullEquivariantAttention(C, LMAX, HEADS),
                         lambda: tga.GlobalFullEquivariantAttention(C, LMAX, HEADS), (K, C)),
    "htr_rope": (lambda: jga.GlobalHTRAttention(C, LMAX, HEADS, use_rope=True),
                 lambda: tga.GlobalHTRAttention(C, LMAX, HEADS, use_rope=True), (K, C)),
    "htr_distance": (lambda: jga.GlobalHTRAttention(C, LMAX, HEADS, use_distance=True),
                     lambda: tga.GlobalHTRAttention(C, LMAX, HEADS, use_distance=True),
                     (K, C)),
}


def _inputs(kind):
    jb, tb = h.batches(seed=5)
    x = np.random.default_rng(6).normal(size=(jb["pos"].shape[0],) + CLASSES[kind][2])
    return jb, tb, x.astype(np.float32), np.asarray(jb["pos"])


@pytest.mark.parametrize("dense", [False, True], ids=["flat", "dense"])
@pytest.mark.parametrize("kind", list(CLASSES))
def test_global_attention_matches_jax(kind, dense):
    jb, tb, x, pos = _inputs(kind)
    jm, tm = CLASSES[kind][0](), CLASSES[kind][1]()
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
