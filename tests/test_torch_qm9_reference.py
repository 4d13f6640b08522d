"""The port's QM9 EquiformerV2 (``models/qm9.py``, ``make_qm9_train_step``)
against the benchmark's plain reference (``portbench/reference/qm9.py``),
the benchmark's molecule generator and its QM9 counts.

On the CPU at a tiny size (2 layers, 16 channels, lmax 2 / mmax 1, seeded
random weights), in the ragged and the fixed-degree layouts, with K3's plain
version (``conv_fused``).  Limits: outputs 1e-5 relative + 1e-6 absolute,
gradients 1e-3 relative + 1e-6 of the leaf's largest entry, parameters and
EMA after a step 1e-6 absolute: float32 on both sides, the sums taken in
another order (the port's sorted segment sums and K3's grouped GEMMs against
``index_add`` and per-m matmuls), over two layers.  The ``cuda`` test runs
the same step on the card at full width with K3's kernels (3xTF32) against
the reference on the card.  This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_qm9_reference.py
"""

import json
import math

import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import infer_pad_sizes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import trainer
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.schedules import (
    warmup_cosine,
)
from portbench.counts import ops as counts_ops
from portbench.counts import qm9 as counts
from portbench.harness.common import BENCH, draw_weights, program_model, reference_model
from portbench.reference.qm9 import Trainer, molecule_batch
from portbench.traffic import molecules

CFG = json.loads((BENCH / "configs" / "qm9-eqv2-k3.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "qm9-pool64.json").read_text())
TINY = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
            attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32, lmax=2,
            mmax=1, edge_channels=16, num_rbf=16)
OPT = dict(CFG["train"], lr=1e-3, warmup_steps=2, total_steps=10)
LAYOUTS = ("ragged", "fixed_degree")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny shapes: one intra-op thread is fastest, the more so beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(**model) -> dict:
    return dict(CFG, model={**CFG["model"], **model}, train=OPT)


def _case(layout: str, device="cpu", n: int = 6, **model):
    """(config, program model, weights, molecules, padded batch)."""
    cfg = _config(**model)
    prog = program_model(cfg, "float32", layout)
    shapes = {k: tuple(t.shape) for k, t in prog.state_dict().items()}
    w = {k: t.cpu() for k, t in draw_weights(shapes, 2 ** 31 + 11, "cpu").items()}
    prog.load_state_dict(w)
    mols = molecules.generate(dict(TRAFFIC, pool=n), 2 ** 31 + 3)
    samples = [graph.GraphSample(atomic_numbers=m["z"], pos=m["pos"], y=m["y"]) for m in mols]
    k, cutoff = CFG["max_neighbors"], cfg["model"]["cutoff"]
    fixed = layout == "fixed_degree"
    n_pad, e_pad = infer_pad_sizes(samples, cutoff, k, n, fixed_degree=fixed)
    pb = graph.collate(samples, cutoff, k, n_pad, e_pad, fixed_degree=fixed)
    assert not (pb.overflow_atoms or pb.overflow_edges)
    return cfg, prog.to(device), w, mols, pb


def _tiny(layout):
    return _case(layout, **TINY)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_outputs_and_gradients_match_the_reference(layout):
    cfg, prog, w, mols, pb = _tiny(layout)
    batch = graph.as_tensors(pb, "cpu")
    prog.train()
    pred = prog(batch)
    trainer.qm9_loss(pred, batch["y"]).backward()
    ref = Trainer(reference_model(cfg), w, OPT, cfg["model"]["cutoff"], CFG["max_neighbors"],
                  "cpu", graphs_per_block=4)
    with torch.no_grad():
        want = ref.m.forward(ref.W, molecule_batch(mols, cfg["model"]["cutoff"],
                                                    CFG["max_neighbors"], "cpu"))
    assert pred.shape == want.shape == (len(mols), 12)
    assert torch.allclose(pred.detach(), want, rtol=1e-5, atol=1e-6)
    _, grads = ref.gradient(mols)
    for name, p in prog.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert torch.allclose(g, grads[name], rtol=1e-3,
                              atol=1e-6 * max(1.0, float(grads[name].abs().max()))), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_one_guarded_adamw_and_ema_step_matches_the_reference(layout):
    cfg, prog, w, mols, pb = _tiny(layout)
    opt = trainer.GuardedAdamW(prog.named_parameters(),
                               warmup_cosine(OPT["lr"], OPT["warmup_steps"], OPT["total_steps"]),
                               OPT["weight_decay"], OPT["grad_clip"])
    state = trainer.create_train_state(prog, opt)
    step = trainer.make_qm9_train_step(state, OPT["loss_kind"], OPT["ema_decay"])
    loss, met = step(graph.as_tensors(pb, "cpu"))
    ref = Trainer(reference_model(cfg), w, OPT, cfg["model"]["cutoff"], CFG["max_neighbors"],
                  "cpu", graphs_per_block=3)
    want = ref.step(mols)
    assert met["accepted"] and float(loss) == pytest.approx(want, rel=1e-6)
    for name, p in prog.named_parameters():
        assert torch.allclose(p.detach(), ref.W[name].detach(), rtol=0, atol=1e-6), name
        assert torch.allclose(state.ema[name], ref.ema[name], rtol=0, atol=1e-6), name


def test_molecules_sizes_elements_and_distances():
    params = dict(TRAFFIC, pool=256)
    pool = molecules.generate(params, 2 ** 31 + 5)
    sizes, counts_ = molecules.size_counts(params)
    assert counts_.sum() == 256
    assert sorted(len(m["z"]) for m in pool) == sorted(np.repeat(sizes, counts_).tolist())
    assert 3 <= min(sizes) and max(sizes) <= 29
    full = molecules.size_counts(TRAFFIC)
    assert abs(float((full[0] * full[1]).sum() / full[1].sum()) - 18.0) < 0.5
    for m in pool:
        z, pos = m["z"], m["pos"]
        heavy = z > 1
        assert set(z.tolist()) <= {1, 6, 7, 8, 9}
        assert heavy.sum() == molecules.heavy_count(len(z), 9) <= 9
        d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        assert d.min() >= TRAFFIC["min_distance"]
        # every atom is bonded: a heavy neighbour within the longest bond
        near = (d <= TRAFFIC["heavy_bond"][1] + 1e-5) & heavy[None, :]
        assert len(z) == 1 or near.any(1).all()
        assert m["y"].shape == (12,)
    again = molecules.generate(params, 2 ** 31 + 5)
    assert all(np.array_equal(a["pos"], b["pos"]) for a, b in zip(pool, again))


def test_qm9_counts_by_hand():
    """K3, the rotations, the S2 activations and the forward FLOPs at the
    tiny size, counted here from the shapes."""
    m = dict(CFG["model"], **TINY)
    N, E, T = 24, 96, 12
    L0, C, H, heads, A, V = 3, 16, 16, 2, 8, 8
    K = L0 + 2 * (L0 - 1)   # lmax 2 / mmax 1: 3 rows at m = 0, 2 at m = 1 and at m = -1
    # K3: conv 1 (2C -> H, extra heads A + H), conv 2 (H -> heads V)
    w1 = L0 * 2 * C * (heads * A + H + L0 * H) + (2 * 2) ** 2 * 2 * C * H
    w2 = L0 * H * (L0 * heads * V) + (2 * 2) ** 2 * H * heads * V
    ops = counts.so2conv_ops(m, CFG["outputs"], "train", "float32", N, E)
    assert len(ops) == 2 * 2 * 2
    assert [o.flops for o in ops[:4]] == [2.0 * E * w1] * 2 + [2.0 * E * w2] * 2
    assert ops[0].bytes == 4 * (E * K * 2 * C + E * K * H + E * (heads * A + H) + w1)
    assert ops[3].bytes == 4 * (E * K * heads * V + E * K * H + w2)
    assert all(o.route == "f32_tc" for o in ops)
    assert math.isclose(ops[0].seconds(), max(ops[0].bytes / 3.35e12,
                                              3 * ops[0].flops / 495e12))
    # rotations: the embedding's, then two a layer; forward and backward
    rot = counts.rotation_ops(m, CFG["outputs"], "train", "float32", N, E)
    assert len(rot) == 2 * (1 + 2 * 2)
    # S2: 2 FFNs at N rows, 2 edge sites at E rows, the heads at T N rows; K2a + K2b
    s2 = counts.s2act_ops(m, CFG["outputs"], "train", "float32", N, E)
    P_full, P_red = 2 * 3 * (5 + 2), 2 * 3 * 3
    want = [(N, 9, 32, P_full)] * 2 + [(E, K, H, P_red)] * 2 + [(T * N, 9, 32, P_full)]
    assert len(s2) == 2 * len(want)
    for (rows, k, c, p), a, b in zip(want, s2[::2], s2[1::2]):
        assert a.flops == 2.0 * 2 * p * k * rows * c and b.flops == 2.0 * 3 * p * k * rows * c
    # forward FLOPs: embedding, two baseline layers, 12 heads
    d = counts_ops._dims(m)
    f = (counts_ops._rad(E, d, L0 * C) + 2.0 * E * 9 * C
         + 2 * (counts_ops._attention(N, E, d, False, P_red, C)
                + counts_ops._ffn(N, d, P_full, C))
         + T * 2.0 * N * (C * 32 + 9 * C * 32 + 2 * P_full * 9 * 32 + 9 * 32 * 1))
    assert counts.forward_flops(m, CFG["outputs"], N, E) == pytest.approx(f)
    assert counts.model_flops(m, CFG["outputs"], "train", N, E) == pytest.approx(3 * f)


@pytest.mark.cuda
def test_k3_qm9_step_on_the_card_matches_the_reference():
    """Full width, 2 layers, 8 molecules, ragged, K3 on: the program's step on
    the card against the float32 reference on the card (TF32 off): loss
    1e-5 relative, each leaf's gradient 2e-3 relative L2 (K3 computes in
    3xTF32, ~2^-21 a product; the reference in float32), every kernel of
    the path launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K3 has no CPU mode)")
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import so2conv

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, prog, w, mols, pb = _case("ragged", "cuda", n=8, num_layers=2)
    before = dict(so2conv.launches)
    prog.train()
    batch = graph.as_tensors(pb, "cuda")
    loss = trainer.qm9_loss(prog(batch), batch["y"])
    loss.backward()
    ran = {k: so2conv.launches[k] - before[k] for k in before}
    assert ran == {"fwd": 4, "adj": 4, "b_operands": 24, "dw": 4}, ran
    ref = Trainer(reference_model(cfg), w, OPT, cfg["model"]["cutoff"], CFG["max_neighbors"],
                  "cuda", graphs_per_block=4)
    want, grads = ref.gradient(mols)
    assert float(loss) == pytest.approx(want, rel=1e-5)
    for name, p in prog.named_parameters():
        g, r = p.grad if p.grad is not None else torch.zeros_like(p), grads[name]
        scale = max(float(r.norm()), 1e-3 * float(np.median([float(v.norm())
                                                             for v in grads.values()])))
        assert float((g - r).norm()) <= 2e-3 * scale, name
