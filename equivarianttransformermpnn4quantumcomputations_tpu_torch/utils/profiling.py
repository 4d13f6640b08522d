"""Where the time goes on the card: torch.profiler over one serving request
or one training step.

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling \
        [--train | --baseline | --qm9 | --oc20 | --variant NAME] [--structures N]
        [--atoms N] [--remat] [--inner-ckpt] [--bf16] [--json PATH]

Serving (default): the flagship Predictor (``models/matpes.py:FLAGSHIP``,
seeded random weights; ragged batches) answers requests of random periodic
structures; ``--mixed``: the mixed-size request (one structure of 120 atoms
and fifteen of 16, ``MIXED``, ``mixed_structures``).
``--train``: one flagship force-training step in bf16 (f32 master weights,
guarded AdamW, EMA; dropout off as in bench.py) on labelled structures
(``data/synthetic.py:labelled_structures``).  ``--baseline``: the same
step of the baseline EquiformerV2 (``gata=False``, the ``baseline``
config's widths, which are the flagship's) with per-graph stress in the
loss (``w_stress`` 0.1).  With ``--remat`` / ``--inner-ckpt`` these two
steps take the MatPES config keys of those names (each block, or the
whole energy evaluation, rematerialized in the backwards: nn/remat.py).
``--qm9``: one f32 (``--bf16``: bf16 compute, f32 masters) training
step of the full-width QM9 model (``configs/qm9.py:config``, seeded random
weights, its dropouts) on 64 random molecules of 18 atoms
(``random_molecules``), once with ``conv_fused`` (kernel K3) and once
without, in that order.  ``--oc20``: one bf16 training step (f32 master
weights, dropout off as in bench.py) of the full OC20 model
(``configs/oc20.py:config``: 12 layers, lmax 6 / mmax 2) on 4 labelled
periodic structures of 72 atoms (``oc20_batch``: cutoff 12, 20
neighbours, N_pad 320, E_pad 6,400), once with the factored Wigner
rotation (kernel K4) and once with the dense one (kernel K1), in that
order.  ``--variant NAME``: one bf16 force-training step of a MatPES
preset of the model registry (``models/registry.py``) at the flagship's
widths with the preset's own overrides (GATA v1: mmax 4), dropout off,
on the ``--train`` batch; a preset with a global-attention stage also
gets that stage profiled alone at the step's shapes (its forward, the
first derivative by its input and the second by its parameters: the
work it adds to a force-training step).  Each profile warms up twice,
times one call unprofiled, then profiles one with ``torch.profiler`` (CPU and CUDA
activities) and prints: the call's time with and without the profiler,
the host time of the graph build and collate, the summed kernel time, the
device busy share (union of kernel intervals over the profiled call's wall
time), the number of kernel launches, the kernel time by bucket, the
device time and launches of the edge-rotation kernels (K1 ``pairs_kernel``
and K4 ``rot_kernel``) and of the S2 activation kernels (K2a, K2b, K2c:
every kernel named ``s2act_*``; K2c apart), of the GATA value activation
kernels (K5a, K5b, K5c: ``gata_value_kernel``) and of K3's weight gradient
(K3-dW: ``so2conv_dw_*``; ``--qm9`` also its edge rows reduced of those
offered, ``so2conv.dw_rows``), and the top kernels.  Every line carries the
card's name and power limit.  Without a CUDA device it raises.

The program's spans (``utils/trace.py``) get a table of their own
(``span_table``, the record's ``spans``): for each ``etq.`` span name its
calls, its host ms, and the device ms and launches of the kernels launched
inside it, taken from the profiler's parent links (an operation's
``cpu_parent`` chain up to the span), not from time overlap; a second pair
of columns, ``backward``, gives the kernels of the backward functions
whose forward operation ran inside the span (the profiler's own link of a
backward function to its forward operation: sequence number and forward
thread; the engine's sums of the gradients a backward function hands on
go with that function), so the autograd engine's work on its own thread,
and the second backward of force training, are put down to the model
sites (``etq.model.*``) that made them.  The row ``(no span)`` holds the
kernels that no span holds either way.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import numpy as np
import torch

from ..data.loader import FIXED_DEGREE, fixed_degree_pads

__all__ = ["random_structures", "random_molecules", "qm9_batch", "qm9_train_state",
           "oc20_batch", "oc20_train_state", "variant_model", "profile_call", "span_table",
           "run", "main", "MIXED", "mixed_structures"]

_BUCKETS = (
    # s2act_tc_kernel: K2a, K2b and K2c; s2act_kernel and s2act_k3_kernel:
    # their FFMA kernels in older trees (this file copied there for an A/B);
    # gata_value_kernel: K5a, K5b and K5c; so2conv_dw: K3-dW and its reduce
    ("port kernels (pairs, s2act, so2conv, rot, gata_value)",
     ("pairs_kernel", "s2act_tc_kernel", "so2conv_kernel", "b_operand_kernel", "rot_kernel",
      "s2act_kernel", "s2act_k3_kernel", "gata_value_kernel", "so2conv_dw")),
    ("optimizer (multi-tensor)", ("multi_tensor",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv", "splitK")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("reductions", ("reduce_kernel",)),
    ("concat / copy", ("copy", "CatArray", "cat_")),
    ("elementwise", ("elementwise", "Functor")),
)


def random_structures(rng: np.random.Generator, n: int, atoms: int) -> list[dict]:
    """Random periodic structures: a ~6 A cell with uniform positions
    (the recipe of the JAX package's __graft_entry__._synthetic_batch)."""
    out = []
    for _ in range(n):
        cell = (np.eye(3) * 6.0 + rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
        pos = (rng.uniform(0, 1, size=(atoms, 3)) @ cell).astype(np.float32)
        z = rng.integers(1, 80, size=atoms).astype(np.int32)
        out.append(dict(atomic_numbers=z, positions=pos, cell=cell))
    return out


# the mixed-size serving request: one large structure and fifteen small
MIXED = (120,) + (16,) * 15


def mixed_structures(rng: np.random.Generator, sizes=MIXED, density_atoms: int = 30) -> list:
    """Random periodic structures of ``sizes`` atoms at ``random_structures``'
    density (``density_atoms`` atoms in a ~6 A cell): each cell's side is
    scaled by the cube root of its atom count."""
    out = []
    for n in sizes:
        side = 6.0 * (n / density_atoms) ** (1.0 / 3.0)
        cell = (np.eye(3) * side + rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
        pos = (rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32)
        out.append(dict(atomic_numbers=rng.integers(1, 80, size=n).astype(np.int32),
                        positions=pos, cell=cell))
    return out


def random_molecules(rng: np.random.Generator, n: int, atoms: int) -> list:
    """``n`` molecules of ``atoms`` atoms (QM9's mean size is 18) with 12
    random normalized targets: elements H, C, N, O, F on jittered sites of
    a 4 x 3 x 2 lattice of 1.3 A spacing (no two atoms closer than 1.1 A;
    nearly every pair within QM9's 5 A cutoff)."""
    from ..data.graph import GraphSample

    sites = np.stack(np.meshgrid(np.arange(4), np.arange(3), np.arange(2), indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32) * 1.3
    if atoms > len(sites):
        raise ValueError(f"at most {len(sites)} atoms")
    out = []
    for _ in range(n):
        pos = sites[rng.permutation(len(sites))[:atoms]]
        pos = pos + rng.uniform(-0.1, 0.1, size=pos.shape).astype(np.float32)
        z = rng.choice(np.array([1, 6, 7, 8, 9], np.int32), size=atoms)
        out.append(GraphSample(atomic_numbers=z, pos=pos.astype(np.float32),
                               y=rng.normal(size=12).astype(np.float32)))
    return out


def qm9_batch(rng: np.random.Generator, n: int, atoms: int, cutoff: float = 5.0):
    """A fixed-degree batch of ``random_molecules``: ``atoms`` node slots per
    molecule and ``atoms - 1`` edge slots per node (every other atom of the
    molecule; QM9's cap of 50 neighbours does not bind)."""
    from ..data.graph import collate

    n_pad = n * atoms
    pb = collate(random_molecules(rng, n, atoms), cutoff, None, n_pad, n_pad * (atoms - 1),
                 fixed_degree=True)
    if pb.overflow_atoms or pb.overflow_edges:
        raise RuntimeError("QM9 batch overflowed its pads")
    return pb


def qm9_train_state(conv_fused: bool, compute_dtype: torch.dtype = torch.float32,
                    fixed_degree: bool = True):
    """The full-width QM9 model (``configs/qm9.py:config``, its dropouts)
    in the fixed-degree layout of ``qm9_batch`` (``fixed_degree=False``:
    the ragged layout, the configuration's own), computing in
    ``compute_dtype`` (float32 masters) with seeded random weights on the
    card, its guarded AdamW, EMA and step."""
    from ..configs.qm9 import config as cfg
    from ..models.matpes import init_weights
    from ..train.schedules import warmup_cosine
    from ..train.train_qm9 import build_model
    from ..train.trainer import GuardedAdamW, create_train_state, make_qm9_train_step

    model = build_model({**cfg, "conv_fused": conv_fused, "fixed_degree": fixed_degree},
                        compute_dtype)
    init_weights(model, torch.Generator().manual_seed(0)).to("cuda")
    opt = GuardedAdamW(model.named_parameters(), warmup_cosine(cfg["lr"], 100, 10000),
                       cfg["weight_decay"], cfg["grad_clip"])
    state = create_train_state(model, opt)
    step = make_qm9_train_step(state, cfg["loss"], cfg["ema_decay"],
                               torch.Generator("cuda").manual_seed(0))
    return state, step


def oc20_batch(rng: np.random.Generator, n: int = 4, atoms: int = 72):
    """A fixed-degree batch of ``n`` labelled periodic structures of
    ``atoms`` atoms (``data/synthetic.py:labelled_structures``) at OC20's
    cutoff 12 and 20 neighbours, with 80 node slots per structure (the
    JAX package's OC20 benchmark layout, bench.py:435-446: N_pad 320,
    E_pad 6,400 at 4 x 72)."""
    from ..data.graph import collate
    from ..data.synthetic import labelled_structures

    n_pad = n * 80
    pb = collate(labelled_structures(rng, n, atoms), 12.0, 20, n_pad, n_pad * 20,
                 fixed_degree=True)
    if pb.overflow_atoms or pb.overflow_edges:
        raise RuntimeError("OC20 batch overflowed its pads")
    return pb


def oc20_train_state(wigner_rep: str):
    """The full OC20 model (``configs/oc20.py:config``, bf16 compute with
    f32 masters, dropouts 0 as in bench.py:437) with seeded random weights
    on the card, its guarded AdamW (bench.py:449: warmup_cosine(4e-4, 100,
    10000), weight decay 1e-3), EMA and step."""
    from ..configs.oc20 import config
    from ..models.matpes import init_weights
    from ..train.schedules import warmup_cosine
    from ..train.train_oc20 import build_oc20_model
    from ..train.trainer import GuardedAdamW, create_train_state, make_oc20_train_step

    cfg = {**config, "alpha_drop": 0.0, "drop_path_rate": 0.0, "wigner_rep": wigner_rep}
    model = build_oc20_model(cfg, torch.bfloat16)
    init_weights(model, torch.Generator().manual_seed(0)).to("cuda")
    opt = GuardedAdamW(model.named_parameters(), warmup_cosine(cfg["lr"], 100, 10000),
                       cfg["weight_decay"], cfg["grad_clip"])
    state = create_train_state(model, opt)
    step = make_oc20_train_step(state, cfg["w_energy"], cfg["w_force"], cfg["ema_decay"],
                                torch.Generator("cuda").manual_seed(0))
    return state, step


def _bucket(name: str) -> str:
    for label, keys in _BUCKETS:
        if any(k in name for k in keys):
            return label
    return "other"


# RecordScope::BACKWARD_FUNCTION: a backward function's event, which carries
# its forward operation's sequence number and thread
_BACKWARD_SCOPE = 1
# the autograd engine's event around a backward function and the sums of the
# gradients it hands on (which lie outside the function's own event)
_ENGINE = "autograd::engine::evaluate_function"
# the row of the kernels that no span holds, directly or by its backward
NO_SPAN = "(no span)"


def span_table(events) -> dict:
    """Per ``etq.`` span name of ``events`` (``prof.events()``): calls, host
    ms, and the device ms and launches of the kernels inside it and of its
    backward (module doc)."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    # the first operation of each (sequence number, thread): the forward one
    # (the engine's events carry their function's number on the engine's
    # thread, so they are no forward operation)
    forward = {}
    for e in sorted(cpu, key=lambda e: e.time_range.start):
        if (e.scope != _BACKWARD_SCOPE and e.sequence_nr >= 0
                and not e.name.startswith(_ENGINE)):
            forward.setdefault((e.sequence_nr, e.thread), e)
    memo: dict = {}

    def spans_of(e) -> tuple[frozenset, frozenset]:
        """(the spans over ``e`` by parent links, those over the forward
        operations of the backward functions ``e`` runs in)."""
        key = id(e)
        if key not in memo:
            own, back, p = set(), frozenset(), e
            while p is not None:
                if p.name.startswith("etq."):
                    own.add(p.name)
                if p.scope == _BACKWARD_SCOPE or p.name.startswith(_ENGINE):
                    fn = p if p.scope == _BACKWARD_SCOPE else next(
                        (c for c in p.cpu_children if c.scope == _BACKWARD_SCOPE), None)
                    f = fn and forward.get((fn.sequence_nr, fn.fwd_thread))
                    if f is not None:
                        back = frozenset().union(*spans_of(f))
                    break
                p = p.cpu_parent
            memo[key] = (frozenset(own), back)
        return memo[key]

    rows: dict = {}

    def row(name):
        return rows.setdefault(name, dict(calls=0, host_ms=0.0, device_ms=0.0, launches=0,
                                          backward_device_ms=0.0, backward_launches=0))

    for e in cpu:
        if e.name.startswith("etq."):
            r = row(e.name)
            r["calls"] += 1
            r["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        if not e.kernels:
            continue
        own, back = spans_of(e)
        ms = sum(k.duration for k in e.kernels) / 1e3
        for name in own or ({NO_SPAN} if not back else ()):
            r = row(name)
            r["device_ms"] += ms
            r["launches"] += len(e.kernels)
        for name in back - own:
            r = row(name)
            r["backward_device_ms"] += ms
            r["backward_launches"] += len(e.kernels)
    return dict(sorted(rows.items()))


def profile_call(fn) -> dict:
    """Time one ``fn()`` on the card unprofiled, then profile another."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t
    # device events, less the spans of record_function annotations (such as
    # the optimizer's step) that the profiler also puts on the device timeline
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    buckets, per_kernel = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        b = _bucket(e.name)
        buckets[b] = buckets.get(b, 0.0) + us / 1e3
        ms, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (ms + us / 1e3, n + 1)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    rotation = [v for k, v in per_kernel.items() if "pairs_kernel" in k or "rot_kernel" in k]
    s2 = [v for k, v in per_kernel.items() if "s2act_" in k]
    k5 = [v for k, v in per_kernel.items() if "gata_value_kernel" in k]
    dw = [v for k, v in per_kernel.items() if "so2conv_dw" in k]
    # K2c: the tensor-core kernel's third instance, or its FFMA kernel in older trees
    k2c = [v for k, v in per_kernel.items()
           if "s2act_k3_kernel" in k or re.search(r"s2act_tc_kernel<[^>]*, 2>", k)]
    return dict(
        ms=wall * 1e3,
        ms_profiled=wall_prof * 1e3,
        kernel_ms=sum(buckets.values()),
        device_busy_ms=busy / 1e3,
        device_busy_share=busy / 1e3 / (wall_prof * 1e3),
        kernel_launches=len(kernels),
        buckets_ms=dict(sorted(buckets.items(), key=lambda kv: -kv[1])),
        rotation_kernel_ms=sum(ms for ms, _ in rotation),
        rotation_kernel_launches=sum(n for _, n in rotation),
        s2act_kernel_ms=sum(ms for ms, _ in s2),
        s2act_kernel_launches=sum(n for _, n in s2),
        k2c_kernel_ms=sum(ms for ms, _ in k2c),
        k2c_kernel_launches=sum(n for _, n in k2c),
        gata_value_kernel_ms=sum(ms for ms, _ in k5),
        gata_value_kernel_launches=sum(n for _, n in k5),
        so2conv_dw_kernel_ms=sum(ms for ms, _ in dw),
        so2conv_dw_kernel_launches=sum(n for _, n in dw),
        top_kernels=[dict(name=k[:160], ms=v[0], count=v[1]) for k, v in top],
        spans=span_table(prof.events()),
    )


def _serving(args) -> tuple[str, dict]:
    from ..inference import Predictor
    from ..models.matpes import FLAGSHIP, EquiformerV2MatPES, init_weights

    model = init_weights(EquiformerV2MatPES(**FLAGSHIP), torch.Generator().manual_seed(0))
    pred = Predictor(model, model.state_dict(), FLAGSHIP["cutoff"], 20, device="cuda")
    rng = np.random.default_rng(0)
    req = (mixed_structures(rng) if args.mixed
           else random_structures(rng, args.structures, args.atoms))
    for _ in range(2):
        pred.predict_batch(req)
    t = time.perf_counter()
    pred.collate(req)
    host_ms = (time.perf_counter() - t) * 1e3
    return "mixed-size request" if args.mixed else "request", dict(host_graph_build_ms=host_ms,
                           **profile_call(lambda: pred.predict_batch(req)))


def _training(args, baseline: bool = False) -> tuple[str, dict]:
    from ..data.graph import as_tensors, collate
    from ..data.synthetic import labelled_structures
    from ..models.matpes import FLAGSHIP, EquiformerV2MatPES, init_weights
    from ..train.schedules import warmup_cosine
    from ..train.trainer import GuardedAdamW, create_train_state, make_matpes_train_step

    model = EquiformerV2MatPES(**FLAGSHIP, alpha_drop=0.0, drop_path_rate=0.0,
                               compute_dtype=torch.bfloat16, gata=not baseline,
                               remat=args.remat, **FIXED_DEGREE)
    init_weights(model, torch.Generator().manual_seed(0)).to("cuda")
    opt = GuardedAdamW(model.named_parameters(), warmup_cosine(2e-4, 100, 10000), 1e-3, 1.0)
    state = create_train_state(model, opt)
    step = make_matpes_train_step(state, w_stress=0.1 if baseline else 0.0,
                                  generator=torch.Generator("cuda").manual_seed(0),
                                  inner_ckpt=args.inner_ckpt)
    samples = labelled_structures(np.random.default_rng(0), args.structures, args.atoms)
    n_pad, e_pad = fixed_degree_pads([args.atoms] * args.structures, 20)
    t = time.perf_counter()
    pb = collate(samples, FLAGSHIP["cutoff"], 20, n_pad, e_pad, fixed_degree=True)
    host_ms = (time.perf_counter() - t) * 1e3
    batch = as_tensors(pb, "cuda")
    for _ in range(2):
        step(batch)
    what = "baseline training step with stress" if baseline else "training step"
    what += "".join(f", {k}" for k, on in (("remat", args.remat),
                                           ("inner_ckpt", args.inner_ckpt)) if on)
    return what, dict(host_graph_build_ms=host_ms, **profile_call(lambda: step(batch)))


def variant_model(name: str, compute_dtype=torch.float32, seed: int = 0, **kw):
    """A MatPES preset of the registry at the flagship's widths (the
    preset's own overrides win, e.g. GATA v1's mmax 4; ``kw`` wins over
    both), dropout off, with seeded random weights, on the CPU."""
    from ..models.matpes import FLAGSHIP, init_weights
    from ..models.registry import get_model, make_model

    overrides = get_model(name)[1]
    widths = {k: v for k, v in FLAGSHIP.items() if k not in overrides}
    model = make_model(name, **{**widths, "alpha_drop": 0.0, "drop_path_rate": 0.0,
                                "compute_dtype": compute_dtype, **kw})
    return init_weights(model, torch.Generator().manual_seed(seed))


def _global_stage_call(model, batch):
    """The preset's global-attention stage alone at the step's shapes: its
    forward on the backbone's output, the derivative by that input (as the
    forces take it) and the derivative of that by the parameters."""
    with torch.no_grad():
        x0 = model.backbone(batch["atomic_numbers"], batch["pos"], batch["graph_idx"],
                            batch["edge_src"], batch["edge_dst"], batch["edge_shift"],
                            batch["edge_mask"], batch["cell"]).x
    gen = torch.Generator("cuda").manual_seed(1)
    ct = torch.randn(x0.shape, generator=gen, device="cuda")

    def call():
        x = x0.clone().requires_grad_(True)
        y = model._global(x, batch, batch["pos"])
        (g,) = torch.autograd.grad((y * ct).sum(), x, create_graph=True)
        (g * ct).sum().backward()

    return call


def _variant(args) -> list[tuple[str, dict]]:
    from ..data.graph import as_tensors, collate
    from ..data.synthetic import labelled_structures
    from ..models.matpes import FLAGSHIP
    from ..train.schedules import warmup_cosine
    from ..train.trainer import GuardedAdamW, create_train_state, make_matpes_train_step

    model = variant_model(args.variant, torch.bfloat16, **FIXED_DEGREE).to("cuda")
    opt = GuardedAdamW(model.named_parameters(), warmup_cosine(2e-4, 100, 10000), 1e-3, 1.0)
    state = create_train_state(model, opt)
    step = make_matpes_train_step(state, generator=torch.Generator("cuda").manual_seed(0))
    samples = labelled_structures(np.random.default_rng(0), args.structures, args.atoms)
    n_pad, e_pad = fixed_degree_pads([args.atoms] * args.structures, 20)
    t = time.perf_counter()
    pb = collate(samples, FLAGSHIP["cutoff"], 20, n_pad, e_pad, fixed_degree=True)
    host_ms = (time.perf_counter() - t) * 1e3
    batch = as_tensors(pb, "cuda")
    for _ in range(2):
        step(batch)
    out = [(f"{args.variant} training step (bf16)",
            dict(host_graph_build_ms=host_ms, **profile_call(lambda: step(batch))))]
    if model.global_attn_kind is not None:
        call = _global_stage_call(model, batch)
        for _ in range(2):
            call()
        out.append((f"{args.variant} global attention ({model.global_attn_kind}) alone: "
                    "forward, first and second derivative",
                    dict(host_graph_build_ms=0.0, **profile_call(call))))
    return out


def _qm9(args, conv_fused: bool) -> tuple[str, dict]:
    from ..data.graph import as_tensors
    from ..ops.cuda import so2conv

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    state, step = qm9_train_state(conv_fused, dtype)
    t = time.perf_counter()
    pb = qm9_batch(np.random.default_rng(0), args.structures, args.atoms)
    host_ms = (time.perf_counter() - t) * 1e3
    batch = as_tensors(pb, "cuda")
    for _ in range(2):
        step(batch)
    rows0 = so2conv.dw_rows("cuda").clone()
    rec = dict(host_graph_build_ms=host_ms, **profile_call(lambda: step(batch)))
    rec["so2conv_dw_rows"] = (so2conv.dw_rows("cuda") - rows0).tolist()   # reduced, offered
    del state, step
    return (f"QM9 training step ({'bf16' if args.bf16 else 'f32'}, conv_fused "
            f"{'on' if conv_fused else 'off'})", rec)


def _oc20(args, wigner_rep: str) -> tuple[str, dict]:
    from ..data.graph import as_tensors

    state, step = oc20_train_state(wigner_rep)
    t = time.perf_counter()
    pb = oc20_batch(np.random.default_rng(0), args.structures, args.atoms)
    host_ms = (time.perf_counter() - t) * 1e3
    batch = as_tensors(pb, "cuda")
    for _ in range(2):
        step(batch)
    rec = dict(host_graph_build_ms=host_ms, **profile_call(lambda: step(batch)))
    del state, step
    return f"OC20 training step (bf16, wigner {wigner_rep})", rec


def _report(card: str, what: str, rec: dict, args) -> dict:
    rec = dict(device=card, what=what, structures=args.structures, atoms=args.atoms,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30, **rec)
    print(f"{what} {rec['ms']:.1f} ms (profiled {rec['ms_profiled']:.1f} ms, "
          f"host graph build + collate {rec['host_graph_build_ms']:.1f} ms), kernels "
          f"{rec['kernel_ms']:.1f} ms in {rec['kernel_launches']} launches, device busy "
          f"{rec['device_busy_ms']:.1f} ms = {100 * rec['device_busy_share']:.1f} % of "
          f"the profiled call, peak memory {rec['peak_memory_gib']:.2f} GiB  [{card}]")
    for b, ms in rec["buckets_ms"].items():
        print(f"  {b:38s} {ms:8.2f} ms  [{card}]")
    print(f"  {'edge-rotation kernels (K1, K4)':38s} {rec['rotation_kernel_ms']:8.2f} ms in "
          f"{rec['rotation_kernel_launches']} launches  [{card}]")
    print(f"  {'S2 activation kernels (K2a, K2b, K2c)':38s} {rec['s2act_kernel_ms']:8.2f} ms in "
          f"{rec['s2act_kernel_launches']} launches  [{card}]")
    print(f"  {'  of which K2c (grad-of-grad)':38s} {rec['k2c_kernel_ms']:8.2f} ms in "
          f"{rec['k2c_kernel_launches']} launches  [{card}]")
    print(f"  {'GATA value kernels (K5a, K5b, K5c)':38s} {rec['gata_value_kernel_ms']:8.2f} ms in "
          f"{rec['gata_value_kernel_launches']} launches  [{card}]")
    print(f"  {'K3 weight gradient (K3-dW)':38s} {rec['so2conv_dw_kernel_ms']:8.2f} ms in "
          f"{rec['so2conv_dw_kernel_launches']} launches  [{card}]")
    if "so2conv_dw_rows" in rec:
        reduced, offered = rec["so2conv_dw_rows"]
        print(f"  K3-dW reduced {reduced} of the {offered} edge rows offered over the timed and "
              f"the profiled call  [{card}]")
    for k in rec["top_kernels"]:
        print(f"  {k['ms']:8.2f} ms x{k['count']:4d}  {k['name'][:110]}")
    if rec["spans"]:
        print(f"  {'span':24s} {'calls':>5s} {'host ms':>9s} {'device ms':>9s} {'launches':>8s} "
              f"{'bwd ms':>9s} {'bwd launches':>12s}  [{card}]")
    for name, r in rec["spans"].items():
        print(f"  {name:24s} {r['calls']:5d} {r['host_ms']:9.2f} {r['device_ms']:9.2f} "
              f"{r['launches']:8d} {r['backward_device_ms']:9.2f} {r['backward_launches']:12d}")
    print(json.dumps({k: v for k, v in rec.items() if k not in ("top_kernels", "spans")}))
    return rec


def run(argv=None) -> list[dict]:
    """Parse ``argv`` as the command line does, profile, print, and return
    the records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile a flagship bf16 training step, not a serving request")
    mode.add_argument("--baseline", action="store_true",
                      help="profile a baseline (no GATA) bf16 training step with stress")
    mode.add_argument("--qm9", action="store_true",
                      help="profile a QM9 training step, with and without kernel K3")
    mode.add_argument("--oc20", action="store_true",
                      help="profile an OC20 training step, factored (K4) and dense (K1)")
    mode.add_argument("--variant", default=None, metavar="NAME",
                      help="profile a bf16 training step of a MatPES registry preset")
    mode.add_argument("--mixed", action="store_true",
                      help="profile the mixed-size serving request (1 x 120 + 15 x 16 atoms)")
    ap.add_argument("--structures", type=int, default=None,
                    help="structures per call (default 16; --qm9: 64 molecules; --oc20: 4)")
    ap.add_argument("--atoms", type=int, default=None,
                    help="atoms per structure (default 30; --qm9: 18; --oc20: 72)")
    ap.add_argument("--remat", action="store_true",
                    help="--train / --baseline: rematerialize each block (the config key)")
    ap.add_argument("--inner-ckpt", action="store_true",
                    help="--train / --baseline: rematerialize the whole energy evaluation")
    ap.add_argument("--bf16", action="store_true",
                    help="--qm9: bf16 compute with f32 master weights")
    ap.add_argument("--json", default=None, help="write the records here too")
    args = ap.parse_args(argv)
    args.structures = args.structures or (64 if args.qm9 else 4 if args.oc20 else 16)
    args.atoms = args.atoms or (18 if args.qm9 else 72 if args.oc20 else 30)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.qm9:
        calls = [lambda: [_qm9(args, True)], lambda: [_qm9(args, False)]]
    elif args.oc20:
        calls = [lambda: [_oc20(args, "factored")], lambda: [_oc20(args, "dense")]]
    elif args.train or args.baseline:
        calls = [lambda: [_training(args, args.baseline)]]
    elif args.variant:
        calls = [lambda: _variant(args)]
    else:
        calls = [lambda: [_serving(args)]]
    recs = []
    for call in calls:
        torch.cuda.reset_peak_memory_stats()
        recs += [_report(card, what, rec, args) for what, rec in call()]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(recs if len(recs) > 1 else recs[0], f, indent=1)
    return recs


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
