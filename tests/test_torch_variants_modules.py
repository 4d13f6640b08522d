"""The variant modules alone: the port against the JAX package on the CPU.

Each module of the MatPES variant family runs on the same numpy-seeded
inputs with the same random params (Flax's, converted by utils/convert.py):
the four equivariant norms (``get_normalization_layer``'s three types and
the per-degree layer scale), the gate activation, the FFN's activation
options, the eSEN FFN, the GATA v1 value activation, both MoE FFNs (every
expert's output and the routing entropy too), AngularHTR and the
tensor-product FFN.  Output, input gradients and parameter gradients of a
random cotangent are held to 1e-5 (relative to the largest value; the
parameter gradients relative L2).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.nn import activations as jact
from equivarianttransformermpnn4quantumcomputations_tpu.nn import dual_stream as jdual
from equivarianttransformermpnn4quantumcomputations_tpu.nn import ffn as jffn
from equivarianttransformermpnn4quantumcomputations_tpu.nn import gata as jgata
from equivarianttransformermpnn4quantumcomputations_tpu.nn import moe as jmoe
from equivarianttransformermpnn4quantumcomputations_tpu.nn import norms as jnorms
from equivarianttransformermpnn4quantumcomputations_tpu.ops.s2grid import s2grid as js2grid
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import activations as tact
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import dual_stream as tdual
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import ffn as tffn
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import gata as tgata
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import moe as tmoe
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import norms as tnorms
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.s2grid import s2grid

import torch_variant_helpers as h

LMAX, C, H, EC = 2, 8, 12, 6
K = (LMAX + 1) ** 2
N, KS = 6, 3                      # nodes and edge slots per node
FIXED_BLOCKS = (1, N, N * KS, KS)  # the port's fixed-degree layout of _graph's edges
TOL = 1e-5


def _graph(seed=0):
    """Fixed-degree edges: node i owns slots [i KS, (i+1) KS); node 5 has
    no real edge."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(N), KS)
    src = rng.integers(0, N, size=N * KS)
    mask = rng.uniform(size=N * KS) < 0.8
    mask[5 * KS:] = False
    return src, dst, mask


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(mod, *args):
    return h.random_like_tree(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), *args)))


def _check(errs):
    print(errs)
    assert all(v <= TOL for v in errs.values()), errs


class _JNorm(fnn.Module):
    norm_type: str

    @fnn.compact
    def __call__(self, x):
        if self.norm_type == "degree_scale":
            return jnorms.EquivariantDegreeLayerScale(LMAX, C, name="norm")(x)
        return jnorms.get_normalization_layer(self.norm_type, LMAX, C)(x)


class _TNorm(torch.nn.Module):
    def __init__(self, norm_type):
        super().__init__()
        self.norm = (tnorms.EquivariantDegreeLayerScale(LMAX, C) if norm_type == "degree_scale"
                     else tnorms.get_normalization_layer(norm_type, LMAX, C))

    def forward(self, x):
        return self.norm(x)


@pytest.mark.parametrize("norm_type", tnorms.NORM_TYPES + ("degree_scale",))
def test_norms_match_jax(norm_type):
    x = _x(0, N, K, C)
    jm = _JNorm(norm_type)
    params = _init(jm, x)
    tm = _TNorm(norm_type)
    _check(h.module_errors(jm.apply, params, tm, tm, [x]))


def test_gate_activation_matches_jax():
    g, x = _x(1, N, LMAX * C), _x(2, N, 7, C)       # (lmax 2, mmax 1): 7 coefficients
    _check(h.module_errors(lambda p, a, b: jact.gate_activation(a, b, LMAX, 1, C), {}, None,
                           lambda a, b: tact.gate_activation(a, b, LMAX, 1, C), [g, x]))


@pytest.mark.parametrize("option", [dict(use_gate_act=True), dict(use_sep_s2_act=False),
                                    dict(use_grid_mlp=True),
                                    dict(use_grid_mlp=True, use_sep_s2_act=False)],
                         ids=["gate", "s2", "grid_mlp_sep", "grid_mlp"])
def test_ffn_options_match_jax(option):
    x = _x(3, N, K, C)
    jm = jffn.FeedForward(C, H, C, LMAX, js2grid(LMAX, LMAX, None), **option)
    tm = tffn.FeedForward(C, H, C, LMAX, s2grid(LMAX, LMAX, None), **option)
    _check(h.module_errors(jm.apply, _init(jm, x), tm, tm, [x]))


def test_esen_ffn_matches_jax():
    x = _x(4, N, K, C)
    jm = jffn.ESENFeedForward(C, H, C, LMAX)
    tm = tffn.ESENFeedForward(C, H, C, LMAX)
    _check(h.module_errors(jm.apply, _init(jm, x), tm, tm, [x]))


def test_gata_v1_value_activation_matches_jax():
    gates, xj, rl = _x(5, N * KS, (1 + 2 * LMAX) * C), _x(6, N * KS, K - 1, C), _x(7, N * KS, K - 1)
    _check(h.module_errors(
        lambda p, *a: jgata.gata_value_activation_v1(*a, LMAX, C), {}, None,
        lambda *a: tgata.gata_value_activation_v1(*a, LMAX, C), [gates, xj, rl]))


@pytest.mark.parametrize("breaking", [False, True], ids=["moe", "moe_breaking"])
def test_moe_ffn_and_routing_entropy_match_jax(breaking):
    src, dst, mask = _graph()
    x, t = _x(8, N, K, C), _x(9, N * KS, EC)
    jm = jmoe.MoEHTRFeedForward(C, H, EC, LMAX, num_experts=3, breaking_equivariance=breaking)
    tm = tmoe.MoEHTRFeedForward(C, H, EC, LMAX, num_experts=3, breaking_equivariance=breaking)
    params = _init(jm, x, t, jnp.asarray(dst), jnp.asarray(mask))
    _check(h.module_errors(lambda p, a, b: jm.apply(p, a, b, dst, mask)[0], params, tm,
                           lambda a, b: tm(a, b, torch.as_tensor(dst), torch.as_tensor(mask),
                                           FIXED_BLOCKS), [x, t]))
    entropy = h.run_jax(lambda p: jm.apply(p, x, t, dst, mask)[1], params)
    np.testing.assert_allclose(float(tm.routing_entropy), float(entropy), rtol=1e-6)


@pytest.mark.parametrize("kind", ["eq", "ne"])
def test_each_stacked_expert_matches_jax(kind):
    """The experts keep JAX's stacking order: expert e of the port computes
    what expert e of the vmapped Flax stack computes."""
    x, c = _x(10, N, K, C), _x(11, N, EC)
    cls = {"eq": (jmoe.EquivariantExpertFFN, tmoe.EquivariantExpertFFN),
           "ne": (jmoe.NonEquivariantExpertFFN, tmoe.NonEquivariantExpertFFN)}[kind]
    jm = fnn.vmap(cls[0], variable_axes={"params": 0}, split_rngs={"params": True},
                  in_axes=None, out_axes=0, axis_size=3)(C, H, EC, LMAX)
    tm = cls[1](3, C, H, EC, LMAX)
    params = _init(jm, x, c)
    _check(h.module_errors(jm.apply, params, tm, tm, [x, c]))
    want = np.asarray(jm.apply(params, x, c))
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(c)).numpy()
    for e in range(3):
        assert h.rel(got[e], want[e]) <= TOL, e


def test_angular_htr_matches_jax():
    src, dst, mask = _graph(1)
    a, t, x = _x(12, N * KS, EC), _x(13, N * KS, EC), _x(14, N, K, C)
    jm = jdual.AngularHTR(C, EC, LMAX)
    tm = tdual.AngularHTR(C, EC, LMAX)
    params = _init(jm, a, t, x, src, dst, mask)
    _check(h.module_errors(lambda p, *v: jm.apply(p, *v, src, dst, mask), params, tm,
                           lambda *v: tm(*v, torch.as_tensor(src), torch.as_tensor(dst),
                                         torch.as_tensor(mask), FIXED_BLOCKS),
                           [a, t, x]))


def test_tensor_product_ffn_matches_jax():
    src, dst, mask = _graph(2)
    x, t, a = _x(15, N, K, C), _x(16, N * KS, EC), _x(17, N * KS, EC)
    jm = jdual.TensorProductFFN(C, H, EC, LMAX)
    tm = tdual.TensorProductFFN(C, H, EC, LMAX)
    params = _init(jm, x, t, a, dst, mask)
    _check(h.module_errors(lambda p, *v: jm.apply(p, *v, dst, mask), params, tm,
                           lambda *v: tm(*v, torch.as_tensor(dst), torch.as_tensor(mask),
                                         FIXED_BLOCKS), [x, t, a]))
