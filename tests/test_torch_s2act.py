"""K2 (fused S2 activation): the port against the JAX package.

The same inputs, made by numpy from a seed, go through the JAX package's
ops/pallas/s2act.py (its Pallas kernels in interpret mode, as
tests/test_pallas_s2act.py runs them, and ``s2act_reference``) and through
the port's ops/cuda/s2act.py, whose wrapper runs the kernels' plain
versions on CPU tensors.  K2a (forward), K2b (its backward, the force
path) and K2c (the backward of K2b, the force-training loss backward) are
held to rtol 1e-4 / atol 1e-5 in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.ops import s2grid as js2g
from equivarianttransformermpnn4quantumcomputations_tpu.ops.pallas import s2act as js2a
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.activations import (
    s2_activation,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import s2grid as ts2g
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import s2act as ts2a

RTOL, ATOL = 1e-4, 1e-5
N, C = 20, 16
GRIDS = [(2, 2, None), (2, 1, None), (4, 4, 18)]


@pytest.mark.parametrize("key", GRIDS, ids=str)
def test_grid_tables_match_jax(key):
    gj, gt = js2g.s2grid(*key), ts2g.s2grid(*key)
    P = gj.res_beta * gj.res_alpha
    A, F = gt.tables("cpu")
    np.testing.assert_allclose(A.numpy(), np.asarray(gj.to_grid_mat).reshape(P, -1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(F.numpy(), np.asarray(gj.from_grid_mat).reshape(P, -1),
                               rtol=1e-5, atol=1e-6)


def _data(key, seed=0):
    K = ts2g.s2grid(*key).to_grid_np.shape[1]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, K, C)).astype(np.float32)
    g = rng.normal(size=(N, K, C)).astype(np.float32)
    return x, g


@pytest.mark.parametrize("key", GRIDS[:2], ids=str)
def test_forward_matches_jax(key):
    x, _ = _data(key)
    gj, gt = js2g.s2grid(*key), ts2g.s2grid(*key)
    out = ts2a.s2act_fused(torch.as_tensor(x), gt).numpy()
    np.testing.assert_allclose(out, np.asarray(js2a.s2act_fused(jnp.asarray(x), gj)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, np.asarray(js2a.s2act_reference(jnp.asarray(x), gj)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts2a.s2act_reference(torch.as_tensor(x), gt).numpy(), out,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("key", GRIDS[:2], ids=str)
def test_backward_matches_jax(key):
    """K2b: the cotangent of the fused activation (the kernel chain's vjp)."""
    x, g = _data(key)
    gj, gt = js2g.s2grid(*key), ts2g.s2grid(*key)
    _, vjp = jax.vjp(lambda a: js2a.s2act_fused(a, gj), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    xt = torch.as_tensor(x).requires_grad_(True)
    (out,) = torch.autograd.grad(ts2a.s2act_fused(xt, gt), xt, torch.as_tensor(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ts2a.k2_plain(torch.as_tensor(x), torch.as_tensor(g), *gt.tables("cpu")).numpy(),
        np.asarray(ref), rtol=RTOL, atol=ATOL,
    )


@pytest.mark.parametrize("key", GRIDS, ids=str)
def test_grad_of_grad_matches_jax(key):
    """K2c through autograd: d/dx <grad_x L(x), w> with L = <out, w1> +
    |out|^2 / 2, so both of K2c's outputs (dx2, and ddout through K2b) carry
    into the result; and k3_plain against the JAX package's _s2_bwd_bwd."""
    x, w = _data(key)
    rng = np.random.default_rng(1)
    w1 = rng.normal(size=x.shape).astype(np.float32)
    ddx = rng.normal(size=x.shape).astype(np.float32)
    gj, gt = js2g.s2grid(*key), ts2g.s2grid(*key)

    def inner_j(a):
        out = js2a.s2act_fused(a, gj)
        return jnp.vdot(out, jnp.asarray(w1)) + 0.5 * jnp.vdot(out, out)

    ref = jax.grad(lambda a: jnp.vdot(jax.grad(inner_j)(a), jnp.asarray(w)))(jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    out = ts2a.s2act_fused(xt, gt)
    inner = (out * torch.as_tensor(w1)).sum() + 0.5 * out.square().sum()
    (g,) = torch.autograd.grad(inner, xt, create_graph=True)
    (got,) = torch.autograd.grad((g * torch.as_tensor(w)).sum(), xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)

    A, F = js2a._tables(gj.cache_key)
    dx2_j, ddout_j, _, _ = js2a._s2_bwd_bwd(
        (jnp.asarray(x), jnp.asarray(w1), jnp.asarray(A), jnp.asarray(F)), jnp.asarray(ddx))
    ddout, dx2 = ts2a.k3_plain(torch.as_tensor(x), torch.as_tensor(w1), torch.as_tensor(ddx),
                               *gt.tables("cpu"))
    np.testing.assert_allclose(ddout.numpy(), np.asarray(ddout_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx2.numpy(), np.asarray(dx2_j), rtol=RTOL, atol=ATOL)


def test_third_order_raises():
    x, _ = _data(GRIDS[0])
    gt = ts2g.s2grid(*GRIDS[0])
    xt = torch.as_tensor(x).requires_grad_(True)
    (g,) = torch.autograd.grad(ts2a.s2act_fused(xt, gt).square().sum(), xt,
                               create_graph=True)
    (g2,) = torch.autograd.grad(g.square().sum(), xt, create_graph=True)
    with pytest.raises(NotImplementedError, match="third-order"):
        torch.autograd.grad(g2.sum(), xt)


def test_cpu_tensors_take_the_unfused_path_and_agree():
    """s2_activation routes CPU tensors to the tensor ops, equal to K2a's
    plain version (CUDA tensors take the kernel at any channel count)."""
    gt = ts2g.s2grid(*GRIDS[0])
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 9, 128)),
                        dtype=torch.float32)
    np.testing.assert_allclose(s2_activation(x, gt).numpy(),
                               ts2a.s2act_fused(x, gt).numpy(), rtol=RTOL, atol=ATOL)
    assert ts2a.launches == {"k1": 0, "k2": 0, "k3": 0}
