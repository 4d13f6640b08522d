"""The program's spans (``utils/trace.py``): free without a profiler, no
change to any number with one, the phases of each unit in place, and one
sync span per host sync.

The units are the benchmark's: a bf16 fixed-degree MatPES training step and
a bf16 OC20 step, each with its loader read and upload, and one ragged
float32 ``Predictor`` request.  On the CPU at tiny widths; the ``cuda``
tests run the same units at the configurations' widths on the card, where
``torch.cuda.set_sync_debug_mode("warn")`` names every operation that
blocks the host on the stream.  This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_trace.py
"""

import collections
import dataclasses
import linecache
import os
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import (
    FIXED_DEGREE,
    PaddedLoader,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
    labelled_structures,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    FLAGSHIP,
    EquiformerV2MatPES,
    init_weights,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.oc20 import (
    EquiformerV2OC20,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.schedules import (
    warmup_cosine,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    create_train_state,
    make_matpes_train_step,
    make_oc20_train_step,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import profiling, trace

UNITS = ("matpes_step", "oc20_step", "request")
TINY = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
            edge_channels=8, num_rbf=8, cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
# host syncs of one unit on the CPU paths, by site: 13 uploads of a labelled
# batch (11 of a request), the dense Wigner's uploads and host indexes
# (lmax 4 / mmax 2: 4 J blocks, 2 kept-row indexes, 5 constants), the
# factored Wigner's tables (OC20: 12 for the "to" pair, 14 for the rescaled
# "from" pair), the guard, the OC20 force head's host index, and a
# request's two copies back
CPU_SYNCS = {
    "matpes_step": {"h2d": 13, "wigner_j": 4, "wigner_index": 2, "wigner_consts": 5,
                    "guard": 1},
    "oc20_step": {"h2d": 13, "rot_consts": 26, "guard": 1, "force_index": 1},
    "request": {"h2d": 11, "wigner_j": 4, "wigner_index": 2, "wigner_consts": 5, "d2h": 2},
}


def _optimizer(model):
    return GuardedAdamW(model.named_parameters(), warmup_cosine(2e-4, 100, 10000), 1e-3, 1.0)


def _train_unit(kind: str, device, full: bool):
    """``(unit, outputs)``: one call reads the loader's next batch, uploads
    it and takes one bf16 step; ``outputs()`` the parameters and the EMA."""
    torch.manual_seed(0)
    if kind == "matpes_step":
        widths = FLAGSHIP if full else dict(TINY, lmax=4, mmax=2)
        model = EquiformerV2MatPES(**{**widths, "alpha_drop": 0.0, "drop_path_rate": 0.0},
                                   compute_dtype=torch.bfloat16, **FIXED_DEGREE)
        n, atoms, cutoff, slots = (8, 30, FLAGSHIP["cutoff"], 31) if full else (2, 6, 5.0, 8)
    else:
        from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs.oc20 import (
            config,
        )
        from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_oc20 import (
            build_oc20_model,
        )

        if full:
            model = build_oc20_model({**config, "alpha_drop": 0.0, "drop_path_rate": 0.0},
                                     torch.bfloat16)
        else:
            model = EquiformerV2OC20(**TINY, lmax=6, mmax=2, avg_num_nodes=6.0,
                                     avg_degree=5.0, compute_dtype=torch.bfloat16,
                                     wigner_rep="factored", **FIXED_DEGREE)
        n, atoms, cutoff, slots = (4, 72, 12.0, 80) if full else (2, 6, 5.0, 8)
    init_weights(model, torch.Generator().manual_seed(0)).to(device)
    state = create_train_state(model, _optimizer(model))
    step = (make_matpes_train_step(state) if kind == "matpes_step"
            else make_oc20_train_step(state))
    # no stress labels, as the force-training configurations have none
    data = [dataclasses.replace(g, stress=None)
            for g in labelled_structures(np.random.default_rng(0), 4 * n, atoms)]
    loader = PaddedLoader(data, n, cutoff, 20, n * slots, n * slots * 20, prefetch=2,
                          fixed_degree=True)
    batches = iter(loader)

    def unit():
        loss, met = step(as_tensors(next(batches), device))
        return [loss, met["grad_norm"]]

    def outputs():
        return [p.detach() for p in model.parameters()] + list(state.ema.values())

    return unit, outputs


def _request_unit(device, full: bool):
    widths = FLAGSHIP if full else dict(TINY, lmax=4, mmax=2)
    model = EquiformerV2MatPES(**widths)
    init_weights(model, torch.Generator().manual_seed(0))
    pred = Predictor(model, model.state_dict(), widths["cutoff"], 20, device=device)
    rng = np.random.default_rng(0)
    req = (profiling.mixed_structures(rng) if full
           else profiling.mixed_structures(rng, sizes=(9, 5, 5), density_atoms=6))

    def unit():
        out = pred.predict_batch(req)
        return [torch.as_tensor(out["energy"])] + [torch.as_tensor(f) for f in out["forces"]]

    return unit, lambda: []


def _unit(kind: str, device="cpu", full: bool = False):
    return _request_unit(device, full) if kind == "request" else _train_unit(kind, device, full)


def _spans(prof) -> list:
    """The program's spans of a profile: (name, start us, end us), in order."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("etq.")), key=lambda s: (s[1], -s[2]))


def _profiled(fn, device="cpu"):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=acts) as prof:
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
    return out, prof


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = trace.span("etq.step"), trace.sync("guard")
    assert a is b and not isinstance(a, torch.autograd.profiler.record_function)
    with a:
        with b:   # nests and re-enters
            pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(trace.span("etq.step"), torch.autograd.profiler.record_function)
    assert trace.span("etq.step") is a


@pytest.mark.parametrize("kind", UNITS)
def test_a_profiler_changes_no_number(kind):
    """The same unit from the same state, with and without a profiler:
    bit for bit the same outputs, parameters and EMA."""
    unit, outputs = _unit(kind)
    plain = unit() + outputs()
    unit, outputs = _unit(kind)
    traced, prof = _profiled(lambda: unit() + outputs())
    assert _spans(prof), "no span was recorded"
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", UNITS)
def test_phase_spans_nest_in_their_unit(kind):
    unit, _ = _unit(kind)
    unit()
    _, prof = _profiled(unit)
    spans = _spans(prof)
    names = collections.Counter(n for n, _, _ in spans)
    for n in names:
        assert n in trace.NAMES or (n.startswith(trace.SYNC_PREFIX)
                                    and n[len(trace.SYNC_PREFIX):] in trace.SYNC_SITES), n
    top = "etq.request" if kind == "request" else "etq.step"
    (whole,) = [s for s in spans if s[0] == top]
    if kind == "request":
        phases = ("etq.data.collate", "etq.data.h2d", "etq.request.model", "etq.request.d2h")
    else:
        phases = ("etq.step.cast", "etq.step.forward", "etq.step.backward", "etq.step.update")
        for n in ("etq.data.wait", "etq.data.h2d"):   # the loader and upload precede the step
            (s,) = [s for s in spans if s[0] == n]
            assert s[2] <= whole[1], n
        (upd,) = [s for s in spans if s[0] == "etq.step.update"]
        for n in ("etq.step.adamw", "etq.step.ema"):
            (s,) = [s for s in spans if s[0] == n]
            assert _within(s, upd), n
    ph = [s for s in spans if s[0] in phases]
    assert [s[0] for s in ph] == list(phases)          # each once, in this order
    for a, b in zip(ph, ph[1:]):                        # disjoint
        assert a[2] <= b[1], (a, b)
    for s in ph:
        assert _within(s, whole), s
    model_home = "etq.request.model" if kind == "request" else "etq.step.forward"
    (home,) = [s for s in spans if s[0] == model_home]
    model = [s for s in spans if s[0].startswith("etq.model.")]
    assert {s[0] for s in model} >= {"etq.model.wigner", "etq.model.embedding",
                                     "etq.model.attention", "etq.model.ffn", "etq.model.head"}
    for s in model:
        assert _within(s, home), s
    # every sync lies in a phase
    covering = ph + [s for s in spans if s[0] in ("etq.data.wait", "etq.data.h2d")]
    for s in spans:
        if s[0].startswith(trace.SYNC_PREFIX):
            assert any(_within(s, p) for p in covering), s


@pytest.mark.parametrize("kind", UNITS)
def test_cpu_sync_counts(kind):
    unit, _ = _unit(kind)
    unit()
    _, prof = _profiled(unit)
    got = collections.Counter(n[len(trace.SYNC_PREFIX):] for n, _, _ in _spans(prof)
                              if n.startswith(trace.SYNC_PREFIX))
    assert dict(got) == CPU_SYNCS[kind]


def test_span_table_reads_parent_and_backward_links():
    """``utils/profiling.py:span_table`` on events made up in the profiler's
    form: a kernel inside a span by its parent chain, and a backward
    function's kernel through its forward operation's sequence number."""
    from types import SimpleNamespace as E

    cpu = torch.autograd.DeviceType.CPU

    def ev(name, start, end, parent=None, kernels=(), scope=0, seq=-1, thread=1,
           fwd_thread=None):
        e = E(name=name, device_type=cpu, time_range=E(start=start, end=end),
              cpu_parent=parent, cpu_children=[], kernels=[E(duration=d) for d in kernels],
              scope=scope, sequence_nr=seq, thread=thread, fwd_thread=fwd_thread)
        if parent is not None:
            parent.cpu_children.append(e)
        return e

    fwd = ev("etq.step.forward", 0, 100)
    attn = ev("etq.model.attention", 10, 60, fwd)
    mm = ev("aten::mm", 20, 30, attn, kernels=(1000.0, 500.0), seq=7)
    other = ev("aten::add", 70, 80, fwd, kernels=(250.0,), seq=8)
    # the autograd engine's thread: MmBackward0 of sequence number 7 and its
    # kernels, then the engine's sum of the gradient it hands on
    engine = ev("autograd::engine::evaluate_function: MmBackward0", 199, 270, seq=7,
                thread=2)
    node = ev("MmBackward0", 200, 260, engine, scope=1, seq=7, thread=2, fwd_thread=1)
    bmm = ev("aten::mm", 210, 250, node, kernels=(2000.0,), thread=2)
    acc = ev("aten::add", 262, 268, engine, kernels=(500.0,), thread=2)
    free = ev("aten::mul", 300, 310, kernels=(100.0,))
    # grad-of-grad: an op that MmBackward0 ran (sequence number 9 of the
    # engine's thread), its own backward function, and an earlier engine
    # event that carries another node's number 9 on that thread
    other_node = ev("autograd::engine::evaluate_function: AddBackward0", 150, 160, seq=9,
                    thread=2)
    made = ev("aten::mul", 215, 220, bmm, seq=9, thread=2)
    node2 = ev("MulBackward0", 400, 420, scope=1, seq=9, thread=2, fwd_thread=2)
    mul2 = ev("aten::mul", 405, 410, node2, kernels=(300.0,), thread=2)
    table = profiling.span_table([fwd, attn, mm, other, other_node, engine, node, bmm, made,
                                  acc, free, node2, mul2])
    assert set(table) == {"etq.step.forward", "etq.model.attention", profiling.NO_SPAN}
    assert (table[profiling.NO_SPAN]["device_ms"], table[profiling.NO_SPAN]["launches"]) == \
        (0.1, 1)
    a, f = table["etq.model.attention"], table["etq.step.forward"]
    assert (a["calls"], a["host_ms"], a["device_ms"], a["launches"]) == (1, 0.05, 1.5, 2)
    assert (a["backward_device_ms"], a["backward_launches"]) == (2.8, 3)
    assert (f["device_ms"], f["launches"], f["backward_device_ms"]) == (1.75, 3, 2.8)


def test_span_table_of_a_cpu_step():
    unit, _ = _unit("matpes_step")
    unit()
    _, prof = _profiled(unit)
    table = profiling.span_table(prof.events())
    spans = collections.Counter(n for n, _, _ in _spans(prof))
    assert {n: r["calls"] for n, r in table.items() if n != profiling.NO_SPAN} == dict(spans)
    assert all(r["host_ms"] > 0 for r in table.values())


# ── on the card ────────────────────────────────────────────────────────────


def _sync_warnings(fn) -> collections.Counter:
    """Where ``fn()`` synchronized the host with the card, by file and line
    (the mode's own first warning, that it is a prototype which "does not
    yet detect all synchronizing operations", is no sync)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno} "
        f"{linecache.getline(w.filename, w.lineno).strip()}"
        for w in caught if "called a synchronizing CUDA operation" in str(w.message))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", UNITS)
def test_sync_spans_match_the_card_syncs(kind):
    """Each unit at its configuration's widths on the card: the sync spans
    equal the synchronizing operations that sync debug mode reports."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sync debug mode is the CUDA runtime's)")
    torch.backends.cuda.matmul.allow_tf32 = False
    unit, _ = _unit(kind, "cuda", full=True)
    for _ in range(2):   # first calls fill the per-process caches
        unit()
    torch.cuda.synchronize()
    where = _sync_warnings(unit)
    _, prof = _profiled(unit, "cuda")
    sites = collections.Counter(n[len(trace.SYNC_PREFIX):] for n, _, _ in _spans(prof)
                                if n.startswith(trace.SYNC_PREFIX))
    print(f"{kind}: {sum(where.values())} synchronizing operations {dict(where)}; "
          f"{sum(sites.values())} sync spans {dict(sites)}")
    assert sum(sites.values()) == sum(where.values()), (dict(where), dict(sites))
