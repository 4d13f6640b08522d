"""The QM9 slice: the port's EquiformerV2QM9 and its train step against the
JAX package's.

Two layers at widths where both SO(2)-conv sites of the JAX package's
attention take its fused kernel (Cin = 2 x 64 = 128, hidden 128, extra =
4 heads x 32 + 128 = 256, values 4 x 32 = 128), lmax 4 / mmax 2, the
default S2 grid, FFN 64.  Random Flax params, made by numpy from a seed,
move to the port through utils/convert.py; the same fixed-degree batch of
small molecules goes through both.  ``conv_fused`` runs on both sides
(JAX: its Pallas kernels in interpret mode; the port: K3's plain version)
and off on both sides.  Tolerances: predictions 1e-5 relative to
max|pred|; one train step's loss 1e-6 relative, gradients 1e-4 relative
L2, parameters and EMA after the step 1e-2 lr absolute (Adam's update of a
near-zero gradient is sign-like).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.models.qm9 import (
    EquiformerV2QM9 as JaxQM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu.ops import s2grid as js2g
from equivarianttransformermpnn4quantumcomputations_tpu.train import schedules as jsched
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.qm9 import (
    EquiformerV2QM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import s2grid as ts2g
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import (
    schedules as tsched,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    create_train_state,
    make_qm9_train_step,
    qm9_loss,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

CFG = dict(num_layers=2, sphere_channels=64, attn_hidden_channels=128, num_heads=4,
           attn_alpha_channels=32, attn_value_channels=32, ffn_hidden_channels=64,
           lmax=4, mmax=2, edge_channels=32, num_rbf=32, max_num_elements=10,
           cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
CUTOFF, MAX_NEIGHBORS = 5.0, 8
LR, WARMUP, TOTAL, WD, CLIP = 1e-3, 2, 10, 5e-3, 1.0


def _batch():
    """Three molecules of 5-7 atoms with 12 targets, fixed-degree layout."""
    rng = np.random.default_rng(0)
    samples = []
    for n in (5, 7, 6):
        samples.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 10, size=n).astype(np.int32),
            pos=rng.uniform(0, 3.0, size=(n, 3)).astype(np.float32),
            y=rng.normal(size=12).astype(np.float32)))
    pb = tgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, 24, 24 * MAX_NEIGHBORS,
                        fixed_degree=True)
    return {k: jnp.asarray(v) for k, v in pb.asdict().items()}, tgraph.as_tensors(pb, "cpu")


def _jax_model():
    return JaxQM9(**CFG, fixed_degree=True, uniform_blocks=True, wigner_rep="dense")


def _random_flax_params(jm, batch, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), batch))

    def fill(s):
        fan = s.shape[-2] if len(s.shape) >= 2 else 4
        return (rng.normal(size=s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


def _port_model(params, conv_fused):
    model = EquiformerV2QM9(**CFG, conv_fused=conv_fused)
    model.load_state_dict(flax_to_state_dict(params))
    return model


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(torch.sum((got[k].double() - want[k].double()) ** 2)) for k in want)
    den = sum(float(torch.sum(want[k].double() ** 2)) for k in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("fused", [False, True], ids=["conv_fused_off", "conv_fused_on"])
def test_qm9_model_matches_jax(fused):
    jb, tb = _batch()
    jm = _jax_model()
    params = _random_flax_params(jm, jb)
    with flags.override(wigner="dense", conv_fused="force" if fused else "off"):
        ref = np.asarray(jax.jit(lambda p, b: jm.apply(p, b))(params, jb))
    model = _port_model(params, fused).eval()
    blocks = model.backbone.blocks
    assert all(b.ga.so2_conv_1.fused == b.ga.so2_conv_2.fused == fused for b in blocks)
    with torch.no_grad():
        out = model(tb).numpy()
    assert out.shape == (3, 12)
    err = np.abs(out - ref).max() / np.abs(ref).max()
    print(f"QM9 predictions, conv_fused {fused}: rel err {err:.2e}")  # pytest -s
    assert err <= 1e-5, err


def test_qm9_train_step_matches_jax():
    """One make_qm9_train_step (conv_fused on both sides, dropout 0)."""
    jb, tb = _batch()
    jm = _jax_model()
    params = _random_flax_params(jm, jb, seed=1)

    def loss_fn(p):
        return jtrainer.qm9_loss(jm.apply(p, jb, deterministic=False).astype(jnp.float32),
                                 jb["y"], "l1")

    sched_j = jsched.warmup_cosine(LR, WARMUP, TOTAL)
    tx = jtrainer.make_optimizer(sched_j, WD, CLIP)
    with flags.override(wigner="dense", conv_fused="force"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
        jstate, jm_out = jax.jit(jtrainer.make_qm9_train_step(jm, tx, "l1", 0.9))(
            jtrainer.create_train_state(params, tx), jb, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(jm_out["loss"]), float(loss_j), rtol=1e-7)

    model = _port_model(params, True).train()
    loss_t = qm9_loss(model(tb), tb["y"])
    loss_t.backward()
    loss_t = float(loss_t.detach())
    grads_t = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    grads_j = flax_to_state_dict(grads_j)
    assert grads_t.keys() == grads_j.keys()
    err = _rel_l2(grads_t, grads_j)
    print(f"QM9 step: loss rel err {abs(loss_t - float(loss_j)) / float(loss_j):.2e}, "
          f"gradient rel L2 err {err:.2e}")  # pytest -s
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-6)
    assert err <= 1e-4, err

    opt = GuardedAdamW(model.named_parameters(), tsched.warmup_cosine(LR, WARMUP, TOTAL),
                       WD, CLIP)
    state = create_train_state(model, opt)
    loss, m = make_qm9_train_step(state, "l1", 0.9)(tb)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    assert m["accepted"] and state.step == 1 and opt.count == 1
    want_p, want_e = flax_to_state_dict(jstate.params), flax_to_state_dict(jstate.ema_params)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), rtol=0,
                                   atol=1e-2 * LR, err_msg=k)
        np.testing.assert_allclose(state.ema[k].numpy(), want_e[k].numpy(), rtol=0,
                                   atol=1e-2 * LR, err_msg=k)


@pytest.mark.parametrize("lm", [(4, 2), (4, 4)], ids=str)
def test_default_s2_grid_matches_jax(lm):
    """grid_resolution=None: 10 x 5 points at (4, 2), 10 x 11 at (4, 4)."""
    gj, gt = js2g.s2grid(*lm, None), ts2g.s2grid(*lm, None)
    assert (gt.res_beta, gt.res_alpha) == (gj.res_beta, gj.res_alpha)
    assert (gt.res_beta, gt.res_alpha) == {(4, 2): (10, 5), (4, 4): (10, 11)}[lm]
    P = gt.res_beta * gt.res_alpha
    A, F = gt.tables("cpu")
    np.testing.assert_allclose(A.numpy(), np.asarray(gj.to_grid_mat).reshape(P, -1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(F.numpy(), np.asarray(gj.from_grid_mat).reshape(P, -1),
                               rtol=1e-5, atol=1e-6)


def test_qm9_bf16_step_matches_jax():
    """One bf16 step (bf16 compute, f32 masters; conv_fused on both sides)
    against the JAX package's ``make_qm9_train_step(mixed_precision=True)``
    of a ``compute_dtype='bfloat16'`` model: the step's loss, and the
    gradients of its loss by the masters (``jax.grad`` of the JAX step's
    loss function, compiled apart: in bf16 the two JAX programs' losses
    differ by 9e-5), at the bf16 limits of
    tests/test_torch_oc20.py: loss 2e-2 relative, gradients 5e-2 relative L2.
    The masters after the step are not compared (Adam's first step turns a
    bf16 gradient's sign noise into lr-sized moves)."""
    jb, tb = _batch()
    jm = JaxQM9(**CFG, fixed_degree=True, uniform_blocks=True, wigner_rep="dense",
                compute_dtype="bfloat16")
    params = _random_flax_params(jm, jb, seed=2)

    def loss_fn(p):   # make_qm9_train_step's, mixed_precision=True
        pred = jm.apply(jtrainer.cast_params(p, jnp.bfloat16), jb, deterministic=False)
        return jtrainer.qm9_loss(pred.astype(jnp.float32), jb["y"], "l1")

    tx = jtrainer.make_optimizer(jsched.warmup_cosine(LR, WARMUP, TOTAL), WD, CLIP)
    with flags.override(wigner="dense", conv_fused="force"):
        loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(params)
        _, jm_out = jax.jit(jtrainer.make_qm9_train_step(jm, tx, "l1", 0.9,
                                                         mixed_precision=True))(
            jtrainer.create_train_state(params, tx), jb, jax.random.PRNGKey(0))

    model = EquiformerV2QM9(**CFG, conv_fused=True, compute_dtype=torch.bfloat16)
    model.load_state_dict(flax_to_state_dict(params))
    state = create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                   tsched.warmup_cosine(LR, WARMUP, TOTAL),
                                                   WD, CLIP))
    loss, m = make_qm9_train_step(state, "l1", 0.9)(tb)
    assert m["accepted"] and all(p.dtype == torch.float32 for p in model.parameters())
    grads_t = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    # the step clipped its gradients to the global norm 1 (CLIP): unclip them
    grads_t = {n: g / min(1.0, CLIP / float(m["grad_norm"])) for n, g in grads_t.items()}
    grads_j = flax_to_state_dict(grads_j)
    err_l = abs(float(loss) - float(jm_out["loss"])) / abs(float(jm_out["loss"]))
    err_g = _rel_l2(grads_t, grads_j)
    print(f"QM9 bf16 step: loss rel err {err_l:.2e}, gradient rel L2 err {err_g:.2e}")
    assert err_l <= 2e-2, err_l
    assert err_g <= 5e-2, err_g
