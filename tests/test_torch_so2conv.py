"""K3 (fused SO(2) convolution): the port against the JAX package.

The JAX package's ``SO2Conv`` runs under ``flags.override(conv_fused=...)``:
``"force"`` reaches its Pallas kernels ``_fwd_kernel`` / ``_adj_kernel`` in
interpret mode (as tests/test_so2conv_fused.py runs them), ``"off"`` its
unfused XLA path.  The port's ``SO2Conv(conv_fused=True)`` gets the same
params through utils/convert.py and runs K3's plain versions on CPU tensors.
E = 128 edges at lmax 4 / mmax 2, Cin = Cout = 128, inputs and params from a
numpy seed.  Tolerances: forward 2e-5 abs and rel; first-order gradients
(x and every param) and grad-of-grad 1e-4 relative L2 (float32 sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.nn import so3_layers as jso3
from equivarianttransformermpnn4quantumcomputations_tpu.ops.irreps import (
    layout as jlayout,
)
from equivarianttransformermpnn4quantumcomputations_tpu.ops.pallas import (
    so2conv as jk3,
)
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn import so3_layers as tso3
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
    so2conv as tk3,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.irreps import (
    layout as tlayout,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

E, LMAX, MMAX, C, D = 128, 4, 2, 128, 32
SITES = [(0, False), (256, True)]
MODES = ["force", "off"]


def _rel_l2(got, want) -> float:
    num = sum(float(np.sum((np.asarray(g, np.float64) - np.asarray(w, np.float64)) ** 2))
              for g, w in zip(got, want))
    den = sum(float(np.sum(np.asarray(w, np.float64) ** 2)) for w in want)
    return (num / den) ** 0.5


def _setup(extra, rad, seed=0):
    """JAX module + params, the port's module with the same params, inputs."""
    rng = np.random.default_rng(seed)
    K = int(jlayout(LMAX, MMAX).num_coefficients)
    x = rng.normal(size=(E, K, C)).astype(np.float32)
    scal = rng.normal(size=(E, D)).astype(np.float32) if rad else None
    jm = jso3.SO2Conv(layout=jlayout(LMAX, MMAX), in_channels=C, out_channels=C,
                      extra_m0=extra, rad_channels=(D, D) if rad else None)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, scal))
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[0] if len(s.shape) > 1 else 8)
                   ).astype(np.float32), shapes)  # biases non-zero too
    tm = tso3.SO2Conv(tlayout(LMAX, MMAX), C, C, extra_m0=extra,
                      rad_channels=(D, D) if rad else None, conv_fused=True)
    tm.load_state_dict(flax_to_state_dict(params))
    assert tm.fused
    return jm, params, tm, x, scal


def _jax_apply(jm, params, mode):
    def f(p, xx, ss):
        with flags.override(conv_fused=mode):
            return jm.apply(p, xx, ss)
    return f


def _port_apply(tm, x, scal):
    return tm(x, None if scal is None else torch.as_tensor(scal))


def test_row_maps_and_rad_chunks_match_jax():
    for lm in [(2, 1), (4, 2), (4, 4), (6, 2)]:
        j, t = jk3._row_maps(*lm), tk3._row_maps(*lm)
        assert len(j) == len(t)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jso3._rad_chunk_map(jlayout(*lm)),
                                      tso3._rad_chunk_map(tlayout(*lm)))


def test_unsupported_widths_take_the_unfused_path():
    lay = tlayout(LMAX, MMAX)
    assert tk3.so2conv_supported(lay, 24, 16, 40)
    assert not tk3.so2conv_supported(lay, 12, 16, 0)
    assert not tso3.SO2Conv(lay, 12, 16, conv_fused=True).fused
    assert not tso3.SO2Conv(tlayout(LMAX, 0), 16, 16, conv_fused=True, m0_only=True).fused


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("extra,rad", SITES, ids=["plain_site", "extra_rad"])
def test_forward_matches_jax(extra, rad, mode):
    jm, params, tm, x, scal = _setup(extra, rad)
    y_ref, ex_ref = _jax_apply(jm, params, mode)(params, jnp.asarray(x), scal)
    with torch.no_grad():
        y, ex = _port_apply(tm, torch.as_tensor(x), scal)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-5, atol=2e-5)
    if extra:
        np.testing.assert_allclose(ex.numpy(), np.asarray(ex_ref), rtol=2e-5, atol=2e-5)
    else:
        assert ex is None and ex_ref is None


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("extra,rad", SITES, ids=["plain_site", "extra_rad"])
def test_gradients_match_jax(extra, rad, mode):
    """d/dx and d/d(every param) of sum(y^2) + sum(cos(extra))."""
    jm, params, tm, x, scal = _setup(extra, rad)
    apply = _jax_apply(jm, params, mode)

    def loss(p, xx):
        y, ex = apply(p, xx, scal)
        return jnp.sum(y ** 2) + (jnp.sum(jnp.cos(ex)) if extra else 0.0)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    y, ex = _port_apply(tm, xt, scal)
    total = (y ** 2).sum() + (torch.cos(ex).sum() if extra else 0.0)
    total.backward()
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, gp))
    named = dict(tm.named_parameters())
    assert sd.keys() == named.keys()
    assert _rel_l2([xt.grad.numpy()], [np.asarray(gx)]) <= 1e-4
    assert _rel_l2([named[k].grad.numpy() for k in sd], [sd[k].numpy() for k in sd]) <= 1e-4


@pytest.mark.parametrize("mode", MODES)
def test_grad_of_grad_matches_jax(mode):
    """The force-training pattern: the param gradient of |d/dx inner|^2."""
    jm, params, tm, x, scal = _setup(128, False)
    apply = _jax_apply(jm, params, mode)

    def outer(p):
        def inner(xx):
            y, ex = apply(p, xx, scal)
            return jnp.sum(y ** 2) + jnp.sum(ex ** 2)
        return jnp.sum(jax.grad(inner)(jnp.asarray(x)) ** 2)

    v_ref, g_ref = jax.value_and_grad(outer)(params)
    xt = torch.as_tensor(x).requires_grad_(True)
    y, ex = _port_apply(tm, xt, scal)
    (gx,) = torch.autograd.grad((y ** 2).sum() + (ex ** 2).sum(), xt, create_graph=True)
    v = (gx ** 2).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-4)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, g_ref))
    named = dict(tm.named_parameters())
    assert _rel_l2([named[k].grad.numpy() for k in sd], [sd[k].numpy() for k in sd]) <= 1e-4


@pytest.mark.parametrize("extra", [0, 256])
def test_plain_adjoint_matches_jax_vjp(extra):
    """adj_plain against the vjp (d/dx) of the JAX package's so2conv_fused."""
    rng = np.random.default_rng(1)
    groups = tk3._row_maps(LMAX, MMAX)
    K = sum(map(len, groups))
    cin, cout = 128, 128
    ws = [rng.normal(size=(len(r) * cin, (extra if g == 0 else 0) + len(r) * cout))
          .astype(np.float32) / np.sqrt(len(r) * cin) for g, r in enumerate(groups)]
    x = rng.normal(size=(E, K, cin)).astype(np.float32)
    dy = rng.normal(size=(E, K, cout)).astype(np.float32)
    dex = rng.normal(size=(E, extra)).astype(np.float32) if extra else None
    with flags.override(conv_fused="force"):
        (y_ref, ex_ref), vjp = jax.vjp(
            lambda xx: jk3.so2conv_fused(xx, tuple(map(jnp.asarray, ws)), LMAX, MMAX,
                                         cout, extra), jnp.asarray(x))
        (dx_ref,) = vjp((jnp.asarray(dy), None if dex is None else jnp.asarray(dex)))
    wt = [torch.as_tensor(w) for w in ws]
    y, ex = tk3.fwd_plain(torch.as_tensor(x), wt, LMAX, MMAX, cout, extra)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=2e-5, atol=2e-5)
    dx = tk3.adj_plain(torch.as_tensor(dy), None if dex is None else torch.as_tensor(dex),
                       wt, LMAX, MMAX, cin)
    assert _rel_l2([dx.numpy()], [np.asarray(dx_ref)]) <= 1e-4
