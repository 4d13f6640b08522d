"""K4 (fused factored-Wigner rotation): the port against the JAX package.

The same edge vectors and features, made by numpy from a seed, go through
the JAX package's factored rotation (``ops/rotation.py``: the XLA path
``_rotate_*_factored``, and the fused Pallas kernel of
``ops/pallas/rotate.py`` in interpret mode under
``flags.override(fused_rotate="on")``, as tests/test_pallas_rotate.py runs
it) and through the port's ``ops/cuda/rotate.py``, whose wrapper runs the
kernel's plain version on CPU tensors.  Forward within 1e-5 absolute,
first-order gradients and grad-of-grad within 1e-4, at lmax 4 / mmax 2
and lmax 6 / mmax 2, with E = 40 (not a multiple of any tile).  The
kernel's per-degree packing of the constants is held against the plain
version by a numpy mirror of ``csrc/rotate.cu``'s route (form each edge's
block, then apply it in K1's pair order), and the block build's plain
version against the dense Wigner pairs of the port and the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.ops import rotation as jrot
from equivarianttransformermpnn4quantumcomputations_tpu.ops.irreps import (
    layout as jax_layout,
)
from equivarianttransformermpnn4quantumcomputations_tpu.ops.pallas import (
    rotate_dense as jrd,
)
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags as jflags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import rotation as trot
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import rotate as k4
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
    rotate_dense as trd,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.irreps import (
    layout as torch_layout,
)

E, C = 40, 8
ATOL_FWD, ATOL_GRAD = 1e-5, 1e-4
LM = [(4, 2), (6, 2)]
NAMES = ("rotate_to_edge", "rotate_to_edge_m0", "rotate_from_edge")


def _vectors(seed=0):
    vec = np.random.default_rng(seed).normal(size=(E, 3)).astype(np.float32)
    vec[0] = (0.0, 0.0, 1.3)    # along +z: the frame's pole
    vec[1] = (0.0, 0.0, -0.7)   # along -z
    return vec


@pytest.fixture(scope="module", params=LM, ids=lambda p: f"lmax{p[0]}_mmax{p[1]}")
def wig(request):
    lmax, mmax = request.param
    vec = _vectors()
    wj = jrot.compute_wigner(lmax, jnp.asarray(vec))
    wt = trot.compute_wigner(lmax, torch.as_tensor(vec))
    return lmax, mmax, wj, wt


def _input(lmax, mmax, name, seed=1):
    K = jax_layout(lmax, mmax).num_coefficients if name == "rotate_from_edge" else (lmax + 1) ** 2
    return np.random.default_rng(seed).normal(size=(E, K, C)).astype(np.float32)


def _jax_xla(name, w, x, lay):
    """The JAX package's unfused factored path."""
    if name == "rotate_from_edge":
        return jrot._rotate_from_edge_factored(w, x, lay)
    y = jrot._rotate_to_edge_factored(w, x, lay)
    if name == "rotate_to_edge_m0":
        y = y[:, np.nonzero(np.asarray(lay.m_complex) == 0)[0], :]
    return y


def _jax_fused(name, w, x, lay):
    """The JAX package's Pallas kernel (interpret mode off a TPU)."""
    with jflags.override(fused_rotate="on"):
        return getattr(jrot, name)(w, x, lay)


def _port(name, w, x, lay):
    return getattr(trot, name)(w, x, lay)


def test_factors_match_jax(wig):
    _, _, wj, wt = wig
    for name in ("ca", "sa", "cb", "sb", "cg", "sg"):
        np.testing.assert_allclose(getattr(wt, name).numpy(), np.asarray(getattr(wj, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(wig, name):
    lmax, mmax, wj, wt = wig
    x = _input(lmax, mmax, name)
    lay_j, lay_t = jax_layout(lmax, mmax), torch_layout(lmax, mmax)
    out = _port(name, wt, torch.as_tensor(x), lay_t).numpy()
    for ref_fn in (_jax_xla, _jax_fused):
        ref = np.asarray(ref_fn(name, wj, jnp.asarray(x), lay_j))
        np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL_FWD, err_msg=ref_fn.__name__)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_forward_gap_to_jax(wig, name):
    """bfloat16 input: the port keeps the chain in f32 and rounds once,
    the JAX package rounds h and uv to bf16 after each product (its XLA
    path and its Pallas kernel).  The gap, relative to max |JAX|, is held
    to the bf16 step's 2e-2 (tests/test_torch_train.py) and printed."""
    lmax, mmax, wj, wt = wig
    x = _input(lmax, mmax, name)
    lay_j, lay_t = jax_layout(lmax, mmax), torch_layout(lmax, mmax)
    out = _port(name, wt, torch.as_tensor(x).bfloat16(), lay_t).float().numpy()
    for ref_fn in (_jax_xla, _jax_fused):
        ref = np.asarray(ref_fn(name, wj, jnp.asarray(x, jnp.bfloat16), lay_j), np.float32)
        gap = float(np.abs(out - ref).max() / np.abs(ref).max())
        print(f"{name} lmax {lmax}: bf16 gap to JAX {ref_fn.__name__} {gap:.2e}")
        assert gap <= 2e-2, (ref_fn.__name__, gap)


@pytest.mark.parametrize("name", NAMES)
def test_gradient_matches_jax(wig, name):
    """The backward of each rotate: the other Function of the pair."""
    lmax, mmax, wj, wt = wig
    x = _input(lmax, mmax, name)
    lay_j, lay_t = jax_layout(lmax, mmax), torch_layout(lmax, mmax)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = _port(name, wt, xt, lay_t)
    g = np.random.default_rng(2).normal(size=tuple(y.shape)).astype(np.float32)
    (out,) = torch.autograd.grad(y, xt, torch.as_tensor(g))
    for ref_fn in (_jax_xla, _jax_fused):
        _, vjp = jax.vjp(lambda a: ref_fn(name, wj, a, lay_j), jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(g))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL_GRAD,
                                   err_msg=ref_fn.__name__)


def test_grad_of_grad_matches_jax(wig):
    """Force-style second order through to_edge -> silu -> from_edge (and
    the m = 0 branch): both Functions differentiate each other."""
    lmax, mmax, wj, wt = wig
    x = _input(lmax, mmax, "rotate_to_edge")
    lay_j, lay_t = jax_layout(lmax, mmax), torch_layout(lmax, mmax)

    def outer_jax(rot):
        def e(a):
            h = jax.nn.silu(rot("rotate_to_edge", wj, a, lay_j))
            m0 = rot("rotate_to_edge_m0", wj, a, lay_j)
            return jnp.sum(rot("rotate_from_edge", wj, h, lay_j) ** 2) + jnp.sum(m0 ** 3)

        return jax.grad(lambda a: jnp.sum(jax.grad(e)(a) ** 2))(jnp.asarray(x))

    xt = torch.as_tensor(x).requires_grad_(True)
    h = torch.nn.functional.silu(_port("rotate_to_edge", wt, xt, lay_t))
    m0 = _port("rotate_to_edge_m0", wt, xt, lay_t)
    e = (_port("rotate_from_edge", wt, h, lay_t) ** 2).sum() + (m0 ** 3).sum()
    (g,) = torch.autograd.grad(e, xt, create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), xt)
    for rot in (_jax_xla, _jax_fused):
        ref = np.asarray(outer_jax(rot))
        scale = max(np.abs(ref).max(), 1.0)
        np.testing.assert_allclose(gg.numpy() / scale, ref / scale, rtol=0, atol=ATOL_GRAD,
                                   err_msg=rot.__name__)


def test_factored_matches_dense(wig):
    """The port's two Wigner representations give the same rotates (K4's
    plain version against K1's)."""
    lmax, mmax, _, wt = wig
    wd = trd.compute_wigner_dense(lmax, mmax, torch.as_tensor(_vectors()))
    lay = torch_layout(lmax, mmax)
    for name in NAMES:
        x = torch.as_tensor(_input(lmax, mmax, name))
        np.testing.assert_allclose(_port(name, wt, x, lay).numpy(),
                                   _port(name, wd, x, lay).numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def _emulate_kernel(x, tabs, lmax, mmax, kind):
    """numpy mirror of csrc/rotate.cu: per edge, the block-diagonal matrix
    M from the packed constants (phase A: every degree's H; phase B: for
    each pair of flipped output rows o / f, G's two rows and
    M[o, k] = t3a[o] (G H)[o, k] + t3b[o] (G H)[f, k], laid out per degree
    [out_w][in_w] row-major), then K1's apply over kernel_pair_order."""
    t1a, t1b, t2a, t2b, t3a, t3b = (np.asarray(t, np.float64) for t in tabs[:6])
    W = k4.kernel_pack(lmax, mmax, kind).astype(np.float64)
    x = np.asarray(x, np.float64)
    E = x.shape[0]
    M = np.zeros((E, len(trd.kernel_pair_order(lmax, mmax, kind))))
    wp = poff = 0
    for l, (io, iw, oo, ow) in enumerate(k4.kernel_segments(lmax, mmax, kind)):
        d = 2 * l + 1
        w1a, w1b = W[wp : wp + d * iw], W[wp + d * iw : wp + 2 * d * iw]
        w2a = W[wp + 2 * d * iw : wp + 2 * d * iw + ow * d]
        w2b = W[wp + 2 * d * iw + ow * d : wp + 2 * d * (iw + ow)]
        H = np.zeros((E, d, iw))
        for idx in range(d * iw):
            k = io + idx % iw
            H[:, idx // iw, idx % iw] = w1a[idx] * t1a[:, k] + w1b[idx] * t1b[:, k]
        for o in range((ow + 1) // 2):
            f = ow - 1 - o
            j = l * l + np.arange(d)
            go = w2a[o * d : (o + 1) * d] * t2a[:, j] + w2b[o * d : (o + 1) * d] * t2b[:, j]
            gf = w2a[f * d : (f + 1) * d] * t2a[:, j] + w2b[f * d : (f + 1) * d] * t2b[:, j]
            so, sf = np.einsum("ej,ejk->ek", go, H), np.einsum("ej,ejk->ek", gf, H)
            M[:, poff + o * iw : poff + (o + 1) * iw] = (t3a[:, oo + o, None] * so
                                                         + t3b[:, oo + o, None] * sf)
            M[:, poff + f * iw : poff + (f + 1) * iw] = (t3a[:, oo + f, None] * sf
                                                         + t3b[:, oo + f, None] * so)
        wp += 2 * d * (iw + ow)
        poff += ow * iw
    assert wp == W.size and poff == M.shape[1]
    y = np.zeros((E, t3a.shape[1], x.shape[2]))
    for p, (ko, ki) in enumerate(trd.kernel_pair_order(lmax, mmax, kind)):
        y[:, ko] += M[:, p, None] * x[:, ki]
    return y


@pytest.mark.parametrize("which", list(k4.KINDS) + ["to (rescaled adjoint of from)"])
@pytest.mark.parametrize("lm", k4.INSTANCES, ids=str)
def test_kernel_pack_reproduces_the_plain_version(lm, which):
    """The per-degree blocks the kernel reads hold every nonzero of W1 / W2:
    the kernel's loops over them equal the dense algebra."""
    lmax, mmax = lm
    w = trot.compute_wigner(lmax, torch.as_tensor(_vectors(3)))
    kind = which.split()[0]
    tabs = (k4.tables(w, lmax, mmax, "from")[1] if which != kind
            else k4.tables(w, lmax, mmax, kind)[0])
    x = np.random.default_rng(4).normal(size=(E, tabs[0].shape[1], C)).astype(np.float32)
    want = k4.rot_plain(torch.as_tensor(x), tabs).numpy()
    np.testing.assert_allclose(_emulate_kernel(x, tabs, lmax, mmax, kind), want,
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module", params=k4.INSTANCES, ids=str)
def dense_values(request):
    """The port's factored Wigner of some edges, and the dense Wigner pairs
    of the same edges from the port and from the JAX package, by kind."""
    lmax, mmax = request.param
    vec = _vectors(6)
    wt = trd.compute_wigner_dense(lmax, mmax, torch.as_tensor(vec))
    wj = jrd.compute_wigner_dense(lmax, mmax, jnp.asarray(vec))
    info = jrd._pair_info(lmax, mmax)
    m0, m0_from = info["m0_cols"], info["m0_cols"][info["sigma_m0"]]
    jax_v = {"to": wj.v_to, "from": wj.v_from, "from_res": wj.v_from_res,
             "to_res": wj.v_to_res, "to_m0": np.asarray(wj.v_to)[:, m0],
             "from_m0": np.asarray(wj.v_to)[:, m0_from]}
    port_v = {"to": wt.v_to, "from": wt.v_from, "from_res": wt.v_from_res,
              "to_res": wt.v_to_res, "to_m0": wt.v_to_m0, "from_m0": wt.v_from_m0}
    return lmax, mmax, trot.compute_wigner(lmax, torch.as_tensor(vec)), port_v, jax_v


# the dense values each table set of ``tables(w, kind)`` forms: (its own, its adjoint's)
_BLOCK_OF = {"to": ("to", "from"), "from": ("from_res", "to_res"),
             "to_m0": ("to_m0", "from_m0"), "from_m0": ("from_m0", "to_m0")}


@pytest.mark.parametrize("adjoint", [False, True], ids=["own", "adjoint"])
@pytest.mark.parametrize("kind", k4.KINDS)
def test_block_from_factors_matches_dense_wigner(dense_values, kind, adjoint):
    """The kernel's block build (block_from_factors_plain, in K1's pair
    order) gives the dense Wigner pairs of the same edges, as the port's
    compute_wigner_dense and the JAX package's build them, to 1e-6."""
    lmax, mmax, w, port_v, jax_v = dense_values
    tabs = k4.tables(w, lmax, mmax, kind)[int(adjoint)]
    block_kind = k4.ADJOINT[kind] if adjoint else kind
    got = k4.block_from_factors_plain(tabs, lmax, mmax, block_kind).numpy()
    want = _BLOCK_OF[kind][int(adjoint)]
    np.testing.assert_allclose(got, port_v[want].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jax_v[want]), rtol=0, atol=1e-6)


def test_constant_blob_layout():
    """The offsets the kernel's constexpr layout computes (pack sizes
    2 (2l+1) (in_w + out_w) per degree, INSTANCES x KINDS order)."""
    blob, offsets = k4._const_blob()
    off = 0
    for lmax, mmax in k4.INSTANCES:
        for kind in k4.KINDS:
            assert offsets[(lmax, mmax, kind)] == off
            off += sum(2 * (2 * l + 1) * (iw + ow)
                       for l, (_, iw, _, ow) in enumerate(k4.kernel_segments(lmax, mmax, kind)))
    assert blob.size == off and blob.size * 4 <= 65536
    # at lmax 6 / mmax 2, "to": W1's 910 block entries and half of W2's 940
    assert k4.kernel_pack(6, 2, "to").size == 910 + 940 // 2


def test_adjoint_pair_is_exact_transpose(wig):
    """<to(x), y> == <x, to^T(y)> for both kernel pairs, in float64."""
    lmax, mmax, _, wt = wig
    w64 = trot.WignerFactors(lmax, *(getattr(wt, n).double()
                                     for n in ("ca", "sa", "cb", "sb", "cg", "sg")))
    rng = np.random.default_rng(5)
    for kind in k4.KINDS:
        ts, ta = k4.tables(w64, lmax, mmax, kind)
        ts = tuple(t.double() for t in ts)
        ta = tuple(t.double() for t in ta)
        x = torch.as_tensor(rng.normal(size=(E, ts[0].shape[1], C)))
        y = torch.as_tensor(rng.normal(size=(E, ts[4].shape[1], C)))
        lhs = (k4.rot_plain(x, ts) * y).sum().item()
        rhs = (x * k4.rot_plain(y, ta)).sum().item()
        assert abs(lhs - rhs) <= 1e-9 * abs(lhs), kind


def test_wrapper_names_a_missing_instance():
    """The kernel wrapper refuses an (lmax, mmax) csrc/rotate.cu does not
    instantiate, before touching the card."""
    with pytest.raises(ValueError, match="no instance"):
        k4.rot_kernel(torch.zeros(2, 16, 4), (torch.zeros(1),) * 8, 3, 3, "to")
