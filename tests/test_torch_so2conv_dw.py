"""K3's weight gradient (K3-dW, ``ops/cuda/so2conv.py``) on the CPU: its plain
version ``dws_plain``, its ``live`` rows, the autograd Function that makes it
differentiable (``_SO2ConvDW``, whose backward is K3's own pair), and the
contract the skip rests on: in the ragged layout, every K3 site's output
gradients are exactly zero on the padding rows ``[E_real, E_pad)``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Limits: float32 against float64 2e-6 of max|float64| (one f32 sum over at
most 131 rows); gradcheck and gradgradcheck (fast mode) at their float64 defaults; the
model's gradients with and without the skip 1e-6 relative L2 (the same
float32 sums over fewer rows).  This file imports no JAX.
"""

import json

import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import infer_pad_sizes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models import backbone
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import so2conv as k3
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import trainer
from portbench.harness.common import BENCH, draw_weights, program_model
from portbench.traffic import molecules

# (lmax, mmax, Cin, Cout, extra): a narrow site with extra outputs, QM9's
# conv 2 layout at a small width
SITES = [(2, 1, 16, 8, 8), (4, 2, 8, 16, 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _operands(site, E, dtype, seed=0):
    lmax, mmax, cin, cout, extra = site
    g = torch.Generator().manual_seed(seed)
    K = sum(map(len, k3._row_maps(lmax, mmax)))
    x = torch.randn(E, K, cin, generator=g, dtype=dtype)
    y = torch.randn(E, K, cout, generator=g, dtype=dtype)
    ye = torch.randn(E, extra, generator=g, dtype=dtype) if extra else None
    ws = [torch.randn(len(r) * cin, (extra if i == 0 else 0) + len(r) * cout, generator=g,
                      dtype=dtype) for i, r in enumerate(k3._row_maps(lmax, mmax))]
    return x, y, ye, ws


@pytest.mark.parametrize("direction", ["forward", "adjoint"])
@pytest.mark.parametrize("site", SITES, ids=str)
def test_dws_plain_is_the_weight_gradient_in_float64(site, direction):
    """dws_plain in float32 against the float64 weight gradient of K3's
    forward (x, dy | dextra) and of its adjoint (ddx, dy | dextra), taken
    by autograd of their plain versions."""
    lmax, mmax, cin, cout, extra = site
    x, y, ye, ws = _operands(site, 131, torch.float32)
    wd = [w.double().requires_grad_(True) for w in ws]
    if direction == "forward":
        out, ex = k3.fwd_plain(x.double(), wd, lmax, mmax, cout, extra)
        inner = (out * y.double()).sum() + (0.0 if ye is None else (ex * ye.double()).sum())
    else:   # <adj(y, ye, W), x> = <W, X^T [ye | Y]>
        inner = (k3.adj_plain(y.double(), None if ye is None else ye.double(), wd, lmax, mmax,
                              cin) * x.double()).sum()
    want = torch.autograd.grad(inner, wd)
    got = k3.dws_plain(x, y, ye, lmax, mmax)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert float((a.double() - b).abs().max()) <= 2e-6 * float(b.abs().max())


@pytest.mark.parametrize("live", [0, 1, 57, 131])
@pytest.mark.parametrize("site", SITES, ids=str)
def test_dws_plain_live_rows(site, live):
    """With ``live`` given, the sum over rows [0, live): equal to the full
    reduction once the tail rows of y and y_extra are zero, and to the
    reduction of the first ``live`` rows whatever the tail holds."""
    lmax, mmax = site[:2]
    x, y, ye, _ = _operands(site, 131, torch.float64)
    head = k3.dws_plain(x[:live], y[:live], None if ye is None else ye[:live], lmax, mmax)
    got = k3.dws_plain(x, y, ye, lmax, mmax, torch.tensor(live, dtype=torch.int32))
    for a, b in zip(got, head):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)
    y[live:] = 0.0
    if ye is not None:
        ye[live:] = 0.0
    full = k3.dws_plain(x, y, ye, lmax, mmax)
    for a, b in zip(got, full):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


# small sites for the derivative checks (each output entry a forward)
SMALL = [(2, 1, 8, 8, 8), (4, 2, 8, 8, 0)]


@pytest.mark.parametrize("live", [None, 3])
@pytest.mark.parametrize("site", SMALL, ids=str)
def test_dw_function_first_and_second_derivatives(site, live):
    """_SO2ConvDW's backward (the adjoint in x, the forward in (y,
    y_extra), with the upstream gradients as weights) and its second
    derivatives, through K3's plain versions, in float64 at a small site.
    With ``live``, y and y_extra take their rows [0, live) from the
    arguments and zeros past them, as the contract holds them."""
    lmax, mmax, cin, cout, extra = site
    E = 5
    x, y, ye, _ = _operands(site, E, torch.float64, seed=1)
    n = E if live is None else live
    aux = k3._Aux(lmax, mmax, cin, cout, extra,
                  None if live is None else torch.tensor(live, dtype=torch.int32))
    args = [t.requires_grad_(True) for t in (x, y[:n]) + (() if ye is None else (ye[:n],))]

    def pad(t):
        return torch.cat([t, t.new_zeros((E - n,) + t.shape[1:])])

    def f(x, y, ye=None):
        return k3._SO2ConvDW.apply(x, pad(y), None if ye is None else pad(ye), aux)

    assert torch.autograd.gradcheck(f, args, fast_mode=True)
    assert torch.autograd.gradgradcheck(f, args, fast_mode=True)


@pytest.mark.parametrize("site", SMALL, ids=str)
def test_conv_grad_of_grad_runs_dw_through_the_function(site, monkeypatch):
    """so2conv_fused's first and second derivatives in float64 (gradcheck /
    gradgradcheck), every weight gradient through ``dws``."""
    lmax, mmax, cin, cout, extra = site
    x, _, _, ws = _operands(site, 4, torch.float64, seed=2)
    calls = []
    dws = k3.dws
    monkeypatch.setattr(k3, "dws", lambda *a: calls.append(1) or dws(*a))
    args = [t.requires_grad_(True) for t in [x, *ws]]

    def f(x, *ws):
        y, ex = k3.so2conv_fused(x, ws, lmax, mmax, cout, extra)
        return (y, ex) if extra else y

    assert torch.autograd.gradcheck(f, args, fast_mode=True)
    assert torch.autograd.gradgradcheck(f, args, fast_mode=True)
    assert calls


def _qm9_ragged(num_layers=2):
    """A QM9 program model (K3 on, plain versions on the CPU) at a small
    width, ragged, and a collated batch of 6 molecules of the cell's
    traffic."""
    cfg = json.loads((BENCH / "configs" / "qm9-eqv2-k3.json").read_text())
    traffic = json.loads((BENCH / "traffic" / "qm9-pool64.json").read_text())
    small = dict(num_layers=num_layers, sphere_channels=16, attn_hidden_channels=16,
                 num_heads=2, attn_alpha_channels=8, attn_value_channels=8,
                 ffn_hidden_channels=32, lmax=2, mmax=1, edge_channels=16, num_rbf=16)
    cfg = dict(cfg, model={**cfg["model"], **small})
    prog = program_model(cfg, "float32", "ragged")
    shapes = {k: tuple(t.shape) for k, t in prog.state_dict().items()}
    prog.load_state_dict(draw_weights(shapes, 2 ** 31 + 17, "cpu"))
    mols = molecules.generate(dict(traffic, pool=6), 2 ** 31 + 5)
    samples = [graph.GraphSample(atomic_numbers=m["z"], pos=m["pos"], y=m["y"]) for m in mols]
    k, cutoff = cfg["max_neighbors"], cfg["model"]["cutoff"]
    n_pad, e_pad = infer_pad_sizes(samples, cutoff, k, 6)
    pb = graph.collate(samples, cutoff, k, n_pad, e_pad)
    return prog, graph.as_tensors(pb, "cpu")


def _step(prog, batch):
    prog.zero_grad(set_to_none=True)
    prog.train()
    trainer.qm9_loss(prog(batch), batch["y"]).backward()
    return {n: p.grad.clone() for n, p in prog.named_parameters() if p.grad is not None}


def test_qm9_ragged_padding_rows_take_zero_gradients(monkeypatch):
    """The contract K3-dW's skip rests on: in a QM9 ragged backward (2
    layers, K3 on), every K3 site's output gradients (dy, dextra) are
    exactly 0 on the padding rows [E_real, E_pad), and ``live`` is E_real;
    the parameters' gradients equal those of the full reduction."""
    prog, batch = _qm9_ragged()
    mask = batch["edge_mask"]
    e_real, e_pad = int(mask.sum()), mask.shape[0]
    assert bool(mask[:e_real].all()) and e_real < e_pad
    seen = []
    dws = k3.dws

    def spy(x, y, ye, lmax, mmax, live=None):
        seen.append((y.clone(), None if ye is None else ye.clone(), live))
        return dws(x, y, ye, lmax, mmax, live)

    monkeypatch.setattr(k3, "dws", spy)
    skipped = _step(prog, batch)
    assert len(seen) == 4   # 2 layers x 2 sites
    for y, ye, live in seen:
        assert live is not None and int(live) == e_real
        assert torch.equal(y[e_real:], torch.zeros_like(y[e_real:]))
        if ye is not None:
            assert torch.equal(ye[e_real:], torch.zeros_like(ye[e_real:]))
        assert float(y[:e_real].abs().max()) > 0.0
    monkeypatch.setattr(backbone, "live_rows", lambda edge_mask: None)
    seen.clear()
    full = _step(prog, batch)
    assert len(seen) == 4 and all(live is None for _, _, live in seen)
    assert skipped.keys() == full.keys()
    num = sum(float((skipped[n] - full[n]).double().square().sum()) for n in full)
    den = sum(float(full[n].double().square().sum()) for n in full)
    assert (num / den) ** 0.5 <= 1e-6


def test_live_rows_is_the_last_real_row_plus_one():
    m = torch.tensor([True] * 5 + [False] * 3)
    assert backbone.live_rows(m).dtype == torch.int32 and int(backbone.live_rows(m)) == 5
    assert int(backbone.live_rows(torch.tensor([False, True, False, False]))) == 2
    assert int(backbone.live_rows(torch.zeros(4, dtype=torch.bool))) == 0
    assert int(backbone.live_rows(torch.zeros(0, dtype=torch.bool))) == 0


def test_live_rows_only_where_a_fused_site_reads_them():
    """The backbone makes ``live`` in the ragged layout when a block has a
    fused K3 site, and not without one."""
    prog, batch = _qm9_ragged(num_layers=1)
    assert prog.backbone.k3_sites
    cfg = json.loads((BENCH / "configs" / "qm9-eqv2-k3.json").read_text())
    small = dict(num_layers=1, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
                 attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
                 lmax=2, mmax=1, edge_channels=16, num_rbf=16, conv_fused=False)
    off = program_model(dict(cfg, model={**cfg["model"], **small}), "float32", "ragged")
    assert not off.backbone.k3_sites


def test_dw_roofline_metric_reads_k3_dw_at_the_real_rows():
    """``so2conv_dw_roofline.train`` (portbench/metrics): the device time of
    the kernels named ``so2conv_dw*`` against the weight gradient's bound
    at each unit's real edge count; K3's forward / adjoint kernels are not
    its, nor is K3-dW theirs; None without a K3-dW kernel or outside QM9."""
    from portbench.harness.common import load_cell, load_metric
    from portbench.harness.readings import Readings
    from portbench.harness.trace import Slice

    cfg = load_cell("qm9-train-b64").config
    metric, k3_metric = (load_metric(n) for n in ("so2conv_dw_roofline.train",
                                                  "so2conv_roofline.train"))
    names = ["void (anonymous namespace)::so2conv_dw_kernel<float>(DwParams)",
             "void (anonymous namespace)::so2conv_dw_reduce<float>(DwParams)"]
    sl = Slice(1, device=[(names[0], 0.0, 0.024), (names[1], 0.024, 0.025),
                          ("void so2conv_kernel<float>(Params)", 0.025, 0.1)])
    r = Readings(cfg["model"], cfg["outputs"], "train", "float32", 1.0, [], counts="qm9")
    r.slice, r.slice_shapes = sl, [(2320, 59520, 1166, 17952)]
    m = cfg["model"]
    flops = 2.0 * 17952 * (4587520 + 2048000) * m["num_layers"]
    assert m["num_layers"] == 8
    want = 100.0 * (3 * flops / 495e12) / 0.025   # operation-bound in 3xTF32
    assert metric.read(r) == pytest.approx(want, rel=1e-9)
    assert 0.0 < metric.read(r) < 100.0
    assert k3_metric.read(r) == pytest.approx(
        100 * r.ops.bound_seconds(r.ops.so2conv_ops(m, cfg["outputs"], "train", "float32",
                                                    2320, 59520)) / 0.075)
    r.slice = Slice(1, device=[("void so2conv_kernel<float>(Params)", 0.0, 0.01)])
    assert metric.read(r) is None
    r.slice, r.counts = sl, "ops"
    assert metric.read(r) is None
