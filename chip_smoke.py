#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py        (from any directory; needs one CUDA GPU and nvcc)
    python3 chip_smoke.py --rotation-only
    python3 chip_smoke.py --s2act-only
    python3 chip_smoke.py --composite-only
    python3 chip_smoke.py --pipeline-only
    python3 chip_smoke.py --remat-only
    python3 chip_smoke.py --gata-value-only

``--rotation-only`` runs phases 1 and 2 and phase 3's K1 / K4 rows, and
stops; ``--s2act-only`` the same with phase 3's K2 rows.  Those rows call
only the kernels' wrappers, whose interface is the same since K4 (K2) was
ported, so this script copied into the root of an older checkout times
that checkout's kernels with the same timers and shapes.
``--composite-only`` runs phases 1 and 2 and phase 15, and stops;
``--pipeline-only`` phases 1, 2 and 16; ``--remat-only`` phases 1, 2 and 20;
``--gata-value-only`` phases 1 and 2 and phase 3's K5 rows.

Phase 3 times each kernel two ways, at the same shapes: CUDA events around
one call (median of 15, L2 flushed before each), which also hold the part
of the wrapper's host time that outlasts the flush, and the device-only
timer (``device_ms``: CUDA events around each call, all 15 calls queued
behind a sleep on the card so that it runs them back to back without the
host's share, median of 15, L2 flushed).

Phases, each of which raises on failure:
  1. print the card (name and power limit, from nvidia-smi);
  2. build the hand-written kernels from ``csrc/`` (one nvcc per source, in
     parallel) and print the ptxas register / spill report;
  3. hold every kernel against its plain PyTorch version at the shapes its
     main path gives it, in float32 and bfloat16, and time kernel, plain
     version and (where one exists) a single PyTorch call computing the
     same function, beside the least time the card could take: K1 at the
     flagship's serving shapes and QM9's, f32 and bf16, with a same-bytes
     copy probe, and first order and grad-of-grad through its autograd
     pair; K3 (the fused SO(2)
     convolution and its adjoint) at QM9's conv 1 and conv 2 and the
     flagship's conv 2, with its grad-of-grad, the three cuBLAS GEMMs of
     the site (library, f32 with TF32 off, and bf16) and the port's unfused
     SO2Conv beside it, its bound on the tensor cores (3xTF32 in f32, bf16)
     and the FFMA bound, its f32 error against float64, and its B operands
     (the weight transposed and split into TF32 parts); K4 (the fused
     factored rotation) at OC20's "to" / "from" (lmax 6 / mmax 2) and the
     flagship's "to_m0" / "from_m0" / "from" (lmax 4 / mmax 2), f32 and
     bf16 (as K1), with first-order and grad-of-grad through its autograd
     pair and torch.bmm of the per-edge dense Wigner (library); K2a and K2b
     at every site of the main paths (``K2_SITES``: the flagship's FFN,
     QM9's FFN, edge and head, OC20's node (K = 49) and edge (K = 29), the
     MatPES baseline's edge (K = 19 on the flagship's grid, [9920, 19,
     128])), and K2c at the flagship's, OC20's and the MatPES baseline's,
     each in f32 and bf16, all three on the tensor cores, with the
     tensor-core bound, the FFMA bound, the SFU floor and the tables' L2
     bytes; K5a, K5b and K5c (GATA-V2's value activation, ``K5_SITES``) at
     the flagship training step's 39,680 edges and K5a / K5b at the
     mixed-size request's 7,296, f32 and bf16, beside their bytes bound;
  4. serve 3 requests of 16 periodic structures of 30 atoms through the
     flagship MatPES GATA-V2 ``Predictor`` (bench.py:327-335 widths, seeded
     random weights; ragged batches, as the JAX ``Predictor`` pads them)
     with the launch counts zeroed just before, and fail if a kernel of the
     path was never launched (phase 3's shapes are the same request in the
     fixed-degree layout, the training phases' layout);
  4b. serve the first request again with the same weights on the factored
     Wigner representation: energies and forces must agree with the dense
     run within phase 5's limits, and K4's "to_m0" and "from" must launch;
  5. compare energies and forces of a 4-structure request on the card with
     the CPU plain path;
  6. train: 2 warm-up + 5 timed flagship force-training steps (bf16 compute,
     f32 master weights, guarded AdamW, EMA; bench.py:308-359's step) on
     labelled batches of 16 structures x 30 atoms, with the launch counts
     zeroed just before the timed steps; fail if a kernel of the path (the
     four K1 kinds, K2a, K2b, K2c, K5a, K5b, K5c) was never launched, a loss
     is not finite or the guard skipped a step;
  7. one float32 training step of a 2-layer flagship-width model on 2
     structures, on the card and on the CPU plain path from the same
     weights: loss and gradients must agree, and so must the parameters and
     EMA that the card's step and the CPU's optimizer make of the card's
     gradients;
  8. QM9: 2 + 5 full-width f32 steps (64 molecules x 18 atoms) with K3, the
     same without K3 in turns (the composed A/B), 2 + 5 bf16 steps with K3
     (bf16 compute, f32 masters: step ms by CUDA events, peak memory,
     launches), then 3 evaluation requests with the EMA weights; fail if a
     kernel of the path was never launched, a loss is not finite or the
     guard skipped a step;
  9. one f32 QM9 step (2 layers, full width) on the card against the CPU;
  10. OC20 S2EF: 2 + 5 full-width bf16 training steps (configs/oc20.py:
     12 layers, lmax 6 / mmax 2; f32 masters, dropouts 0) on 4 labelled
     periodic structures of 72 atoms (cutoff 12, 20 neighbours, N_pad 320,
     E_pad 6,400), factored (K4) and dense (K1) arms in turns (factored,
     dense, dense, factored), launch counts zeroed just before the timed
     factored steps; fail if K4's "to" / "from", K2a or K2b never launched,
     a loss is not finite or the guard skipped a step; then 3 evaluation
     requests with the EMA weights;
  11. one f32 OC20 step (2 layers, full width, 2 structures) on the card
     against the CPU: loss <= 1e-4 relative, gradients <= 1e-3 relative L2;
  12. MatPES beyond the synthetic config: (a) 2 + 5 bf16 steps of the
     ``baseline`` config (no GATA, per-graph stress at w_stress 0.1) at its
     full width on phase 6's batches, launch counts zeroed before the timed
     steps; fail if K1 "to" / "from" or K2a / K2b / K2c at K = 19 never
     launched, a loss or stress term is not finite or the guard skipped a
     step; (b) one f32 2-layer baseline step with stress on the card
     against the CPU (loss 1e-4, gradients, forces and stress 1e-3
     relative L2); (c) one full-width bf16 flagship step with
     ``normalize_attn_output=False`` and one with
     ``use_phi_every_layer=True``, finite and accepted; (d) the ``fixture``
     config trained 2 epochs on the card, its checkpoint evaluated by
     train/test_matpes.py on the card and on the CPU and served by
     ``Predictor.from_checkpoint``: the MAEs within phase 5's limits.
  13. the MatPES variant family of the model registry: (a) every MatPES
     preset built by ``make_model`` at the flagship's widths with its own
     overrides (GATA v1: mmax 4), dropout off: one f32 serving request
     (energy + forces) and one bf16 force-training step (guarded AdamW +
     EMA), the first-step ms and each kernel's launches counted from zero;
     fails if an output or loss is not finite, the guard skipped the step,
     or K1 at the preset's (lmax, mmax) or K2 never launched where the path
     runs them; (b) the headline preset (GATA-V2, phi every layer, global
     HTR attention with the RoPE bias, flat layout) on the flagship's
     batches: 3 serving requests, 2 + 7 timed bf16 steps (median ms,
     graphs/s, launches per step, peak memory) and one step profiled by
     utils/profiling.py --variant (with its global-attention stage alone);
     (c) one f32 force-training step of the headline preset, GATA v1 and
     the MoE (2 layers, flagship widths, 2 structures) on the card against
     the CPU plain path (loss 1e-4, gradients and forces 1e-3 relative L2).
     Phase 3 holds K1's (lmax 4, mmax 4) instance, which GATA v1 runs, at
     its four kinds on the flagship's edges too (records
     ``rotate_pairs.<kind>[4,4]``, whose launches are the GATA v1 step's).
  14. data-parallel training (``parallel/data_parallel.py``) on the one card,
     on phase 6's flagship step and layout, in f32 and in bf16 (the main
     path's precision), each held to ``DP_LIMITS``: phase 7's limits in
     f32, in bf16 4x the largest that phases 14-16 read (two runs of the
     same bf16 step on the card give the same bits; (a) prints it): (a)
     one process with data=2 micro-batches, launch counts zeroed just
     before each step; its loss and averaged gradients against the mean of
     the two single-micro-batch steps; fails if a kernel of the path never
     launched; (b) the same step in a one-rank NCCL group (a TCP store on
     localhost): the flat gradient buffer after the all-reduce and the
     division must be bit-identical to the local mean, the all-reduce's ms
     and bytes are printed, the step is held to (a); (c) 2 spawned ranks
     on the one card over gloo (which takes CUDA tensors, through the
     host: no speed number), one micro-batch each, 2 steps per precision:
     parameters and EMA bit-identical on both ranks after each step, loss
     and gradients held to (a), K1's four kinds and K2a-c launched in each
     rank; (d)
     ``train/train_matpes.py --config synthetic --multihost --mesh data=2
     --epochs 1`` as 2 processes over gloo: rank 0 writes the run
     (losses.csv, metrics.json, checkpoints), rank 1 writes nothing; (e)
     the OC20 full-width bf16 data-parallel step at 2 ranks over gloo:
     finite, accepted, replicas identical, K4 "to" / "from" launched; (f)
     the host graph build + collate of a flagship batch with the C++
     neighbour-list builder and with numpy: identical edges, ms of each.
     The ranks load the kernels phase 2 built (a rank that found one
     missing would build its own copy: ``ops/cuda/build.py`` compiles into
     a per-process temporary file and renames it into place).
  15. composite DP x TP x EP x SP training (``parallel/sharding.py``) on the
     one card, each case's ranks spawned over gloo (NCCL places one rank
     per GPU) and held against the one-process step of the same state,
     batches and seed: (a) the flagship at full width, data=1 model=2, f32
     and bf16; (b) the same with ``sp``; (c) the MoE preset under EP, 2
     layers; (d) data=2 model=2, 4 ranks, 2 layers; (e) one ``conv_fused``
     step at model=2, 2 layers (kernel K3 at conv 2's sharded C_in = 64);
     (f) the flagship with ``sp`` on the same structures collated ragged
     (N_pad 496, E_pad 9728: a node's edges straddle the ranks' halves and
     the last rank holds the padded edges), f32 and bf16; (g) the same in
     the graph-uniform layout (N_pad 640, E_pad 12,288), bf16.
     Loss and metrics, energies and forces of a forward, and the gathered
     gradients within ``DP_LIMITS``; the masters and EMA that the
     one-process optimizer makes of the ranks' gradients within 1e-2 lr
     (phase 7); K1's four kinds and K2a-c (and K3 in (e)) launched in every
     rank; each rank's edge shard and collective counts and bytes a step.
     Before them K1 and K2a-c at the sharded shapes against their
     plain versions (phase 3's limits): K1 "from" / "to" on 4 of the 8
     heads, K1 "to_m0" / "from" / "from_m0" on half the edges (``sp``), K1's
     four kinds on the last rank's half of the ragged batch (rows
     ``[sp ragged]``), K2 on 256 of the 512 FFN channels; their rows join
     the kernels' JSON, with the launches of rank 0's bf16 step (a), (b) or
     (f).  The step times are two ranks sharing one card through the host,
     not a tensor-parallel speed.
  16. DP x GPipe pipeline training (``parallel/pipeline.py``) on the one
     card, the flagship at its 6 layers and full width, each case's ranks
     spawned over gloo and held against the one-process step of the same
     state, batches and seed (bfloat16 copies of the masters in bf16, as
     both steps do): (a) data=1 pipe=2 (3 blocks a stage), f32 and bf16;
     (b) pipe=3, f32; (c) data=2 x pipe=2, 4 ranks, bf16.  Loss and
     metrics, the energies and forces of a forward through the pipeline,
     and the gathered gradients within ``DP_LIMITS``; the masters and EMA
     that the one-process optimizer makes of the ranks' gradients within
     1e-2 lr; the ranks' losses equal; K1's four kinds and K2a-c launched
     on every stage.  Per rank: step ms, peak memory, the ring shift's
     bytes a forward tick and in the step, the ticks and bubble ticks (the
     step times are ranks sharing one card through the host, not a
     pipeline speed).  The flagship's kernel rows carry the launches of
     rank 0's bf16 step (a).
  17. the ragged serving path: the mixed-size request (one periodic
     structure of 120 atoms and fifteen of 16, ``profiling.MIXED``) and the first
     16 x 30 request through the ragged ``Predictor`` at full width, each
     against the same request on the CPU and against the same weights
     served in the fixed-degree layout (phase 5's limit values; energies
     per atom, of the request's largest per-atom |E|): N_pad, E_pad, peak
     memory, CUDA-event ms of the device call on a batch collated before
     the clock starts (median of 10 after 2 warm-ups), the host collate
     apart, one profiled call, and K1 / K2 launches of both layouts; the
     16 x 30 request also fixed-degree on the CPU (printed); then K1's
     four kinds and K2a / K2b at the ragged mixed-size request's shapes
     against their plain versions (rows ``rotate_pairs.<kind>[ragged]``,
     ``s2act.k1[ragged]``, ``s2act.k2[ragged]``, with the launches of one
     ragged request);
  18. one full-width flagship bf16 step in the graph-uniform layout and
     one on the ``blocks`` Wigner representation: finite, accepted, K2a-c
     launched (and K1's four kinds in the uniform step);
  19. the gradient half of the flagship bf16 step twice from one state:
     bit for bit equal, or the phase fails; then the host syncs of one
     gradient half and the step's CUDA-event ms (median of 10).
  20. rematerialization (nn/remat.py): the flagship bf16 force-training
     step (phase 6's model, layout and structures) at 16 x 30 and 64 x 30
     atoms with remat off, remat, inner_ckpt and both: from one state and
     batch each mode's gradients against remat off within ``DP_LIMITS``
     (bf16), the off and remat gradient halves twice (the remat half bit
     for bit equal at 16 x 30, phase 19's size); each mode's
     step ms (CUDA events, median of 5 after 2 warm-ups), peak device
     memory and K1 / K2a-c launches per step (all must launch); at 64 x 30
     remat's peak at most 0.6x the peak without; the f32 16 x 30 step's
     remat and inner_ckpt gradients within 1e-5 relative L2 of remat off;
     the remat'd force pass with and without its parameters' VJPs.
Phases 19, 18 and 20 run after phase 7, phase 17 after phase 5.
The line before the last is the kernels' JSON record and the card; the last
line is the device JSON (not with ``--rotation-only``).  Without a CUDA
device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the training phases' batch layout (the CLIs' default): fixed-degree
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import (  # noqa: E402
    FIXED_DEGREE,
    fixed_degree_pads,
)

CUTOFF, MAX_NEIGHBORS = 6.0, 20        # bench.py:338-340
N_STRUCTURES, N_ATOMS, N_REQUESTS = 16, 30, 3
N_WARMUP_STEPS, N_TRAIN_STEPS = 2, 5
QM9_MOLECULES, QM9_ATOMS = 64, 18      # configs/qm9.py batch; QM9's mean size
OC20_GRAPHS, OC20_ATOMS = 4, 72        # bench.py:435 (N_pad 320, E_pad 6,400)
# H100 SXM published peaks: HBM3 bandwidth; FP32 on FFMA, dense TF32 and
# BF16 on the tensor cores
# the graph-uniform layout's node and edge slots per 30-atom structure
# (``infer_pad_sizes``' 1.25 safety, rounded up to 4 and 32)
UNIFORM_SLOTS = (int(np.ceil(N_ATOMS * 1.25 / 4)) * 4,
                 int(np.ceil(N_ATOMS * MAX_NEIGHBORS * 1.25 / 32)) * 32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"ffma": 67e12, "tf32": 495e12, "bf16": 989e12}
PKG = "equivarianttransformermpnn4quantumcomputations_tpu_torch"
TPU_PKG = "equivarianttransformermpnn4quantumcomputations_tpu"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, flush: torch.Tensor, reps: int = 15) -> float:
    """Median CUDA-event time of one call, L2 flushed before each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def device_ms(fn, flush: torch.Tensor, reps: int = 15) -> float:
    """Median device time of one call, with the L2 flushed before each call:
    CUDA events around each call, with all the calls queued behind a sleep
    on the card, so that the card runs them back to back and the host's
    share of a call, which ``time_ms`` also holds, is left out.  The flush
    lies outside each call's events.  Should the card have finished the
    sleep before the host queued the last call, the sleep is doubled and
    the run repeated, up to four times."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        flush.zero_()
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    cycles = int(2e9 * max(0.02, 4 * host_s))  # >= 4x the host's queueing time at <= 2 GHz
    for _ in range(4):
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        for a, b in events:
            flush.zero_()
            a.record()
            fn()
            b.record()
        ahead = not slept.query()
        torch.cuda.synchronize()
        if ahead:
            return float(np.median([a.elapsed_time(b) for a, b in events]))
        cycles *= 2
    raise RuntimeError(f"device timer: the card caught up with the host in four runs "
                       f"(last sleep {cycles // 2} cycles, host {host_s * 1e3:.1f} ms per "
                       f"{reps} calls)")


def bound(bytes_moved: float, flops: float, route: str = "ffma") -> tuple[float, str]:
    """The least time (ms) for the work on ``route``'s units, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[route] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def edge_vectors(batch: dict) -> torch.Tensor:
    """The displacement vectors of a collated batch, as the backbone makes them."""
    pos = batch["pos"]
    return pos[batch["edge_dst"]] + torch.einsum(
        "ek,ekj->ej", batch["edge_shift"].float(),
        batch["cell"][batch["graph_idx"][batch["edge_dst"]]],
    ) - pos[batch["edge_src"]]


def _max_err(got, want, dt, what: str) -> tuple[float, float]:
    err = (got.float() - want.float()).abs().max().item()
    limit = (1e-5 if dt == torch.float32 else 1e-2) * want.float().abs().max().item()
    if not err <= limit:
        raise RuntimeError(f"{what} {dt}: max abs err {err:.3e} > {limit:.3e}")
    return err, limit


def copy_probe_ms(nbytes: int, flush: torch.Tensor) -> float:
    """``dst.copy_(src)`` over two buffers whose read + write bytes are
    ``nbytes``: the card's sustained streaming rate at a kernel's size,
    printed beside it for reading (it is no bound and no yardstick)."""
    src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    return time_ms(lambda: dst.copy_(src), flush)


def time_rotation(kernel, x32, dense32, n_out: int, value_bytes: int, flops: float,
                  flush) -> dict:
    """One K1 / K4 site in f32 and bf16: the kernel, ``torch.bmm`` with the
    per-edge dense Wigner (library), the bound and the copy probe."""
    out = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x, dense = x32.to(dt), dense32.to(dt)
        E, _, C = x.shape
        nbytes = x.element_size() * (x.numel() + E * n_out * C) + value_bytes
        b_ms, b_by = bound(nbytes, flops)
        row = dict(ms=time_ms(lambda: kernel(x), flush),
                   device_ms=device_ms(lambda: kernel(x), flush),
                   library_ms=time_ms(lambda: torch.bmm(dense, x), flush),
                   bound_ms=b_ms, bound_by=b_by, copy_probe_ms=copy_probe_ms(nbytes, flush))
        row["bound_share"] = b_ms / row["ms"]
        row["device_bound_share"] = b_ms / row["device_ms"]
        out[tag] = row
        del x, dense
    return out


def _rotation_line(name: str, site: str, shape, out_shape, t: dict, plain_ms: float,
                   plan, errs: str, tag: str) -> None:
    parts = []
    for dt in ("f32", "bf16"):
        r = t[dt]
        parts.append(f"{dt}: ms {r['ms']:.4f}, device ms {r['device_ms']:.4f}, bound "
                     f"{r['bound_ms']:.4f} ({r['bound_by']}, {100 * r['bound_share']:.0f} % / "
                     f"device {100 * r['device_bound_share']:.0f} %), bmm "
                     f"{r['library_ms']:.4f}, copy probe {r['copy_probe_ms']:.4f}")
    tile = (f"; tile {plan.te} edges x {plan.ct} ch, {plan.stages} stages, {plan.smem} B smem "
            f"(f32)" if plan is not None else "")
    print(f"kernel {name:22s} {site:30s} {list(shape)}->{list(out_shape)} "
          f"{'; '.join(parts)}; plain f32 {plain_ms:.4f}{tile}; err (limit) {errs}  [{tag}]",
          flush=True)


def _plan(which: str, lmax: int, mmax: int, kind: str, C: int):
    """The f32 tile plan of a K1 (``pairs_plan``) or K4 (``rot_plan``) call."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import edge_rotate

    return getattr(edge_rotate, which)(4, lmax, mmax, kind, C)


def _dense_wigner(E: int, n_out: int, n_in: int, pairs, v) -> torch.Tensor:
    """The per-edge dense Wigner [E, n_out, n_in] of a pair list's values."""
    dense = torch.zeros(E, n_out, n_in, device=v.device)
    dense[:, torch.as_tensor(pairs[:, 0], device=v.device),
          torch.as_tensor(pairs[:, 1], device=v.device)] = v
    return dense


def _chain_errors(fn, plain, x, dt, what: str) -> tuple:
    """First order and grad-of-grad through an autograd pair (``fn``)
    against the plain chain: ``plain(x, 0)`` is the operator A,
    ``plain(x, 1)`` its adjoint."""
    xg = x.clone().requires_grad_(True)
    y = fn(xg)
    (gx,) = torch.autograd.grad(0.5 * y.float().square().sum(), xg, create_graph=True)
    (gg,) = torch.autograd.grad(gx.float().square().sum(), xg)
    ata = plain(plain(x, 0), 1)
    return (_max_err(gx.detach(), ata, dt, f"{what} gradient"),
            _max_err(gg, 2 * plain(plain(ata, 0), 1), dt, f"{what} grad-of-grad"))


def _k1_site(kind: str, shape, v, va, site: str, lmax: int, mmax: int, chain: bool, gen,
             flush, tag: str, rotation_only: bool, name: str) -> dict:
    """One K1 site: the kernel against its plain version in f32 and bf16
    (and, with ``chain``, first order and grad-of-grad through its autograd
    pair), timed beside torch.bmm of the per-edge dense Wigner; returns its
    row."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense as rd,
    )

    adj = {"to": "from", "from": "to", "to_m0": "from_m0", "from_m0": "to_m0"}
    info = rd._pair_info(lmax, mmax)
    pairs, n_out = info["pairs"][kind], info["n_out"][kind]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=gen, device="cuda").to(dt)
        e = [_max_err(rd.pairs_apply_kernel(x, v, lmax, mmax, kind),
                      rd.pairs_apply_plain(x, v, lmax, mmax, kind), dt, f"{name} at {site}")]
        if chain:   # through _ToEdge / _FromEdge
            Fn = rd._ToEdge if kind.startswith("to") else rd._FromEdge
            e += _chain_errors(
                lambda a: Fn.apply(a, v, va, lmax, mmax, kind.endswith("m0")),
                lambda a, t: rd.pairs_apply_plain(a, (v, va)[t], lmax, mmax,
                                                  (kind, adj[kind])[t]),
                x, dt, f"{name} at {site}")
        errs[dt] = e
    torch.cuda.synchronize()
    x = torch.randn(shape, generator=gen, device="cuda")
    dense = _dense_wigner(shape[0], n_out, shape[1], pairs, v)
    t = time_rotation(lambda a: rd.pairs_apply_kernel(a, v, lmax, mmax, kind), x, dense,
                      n_out, 4 * v.numel(), 2.0 * len(pairs) * shape[2] * shape[0], flush)
    plain_ms = time_ms(lambda: rd.pairs_apply_plain(x, v, lmax, mmax, kind), flush)
    plan = None if rotation_only else _plan("pairs_plan", lmax, mmax, kind, shape[2])
    err_txt = ", ".join(f"{'f32' if dt == torch.float32 else 'bf16'} "
                        + " / ".join(f"{a:.2e} ({b:.1e})" for a, b in e)
                        for dt, e in errs.items())
    _rotation_line(name, site, shape, (shape[0], n_out, shape[2]), t, plain_ms, plan,
                   err_txt, tag)
    return dict(
        site=site, shape=list(shape), out_shape=[shape[0], n_out, shape[2]],
        plain_ms=plain_ms, err_f32=errs[torch.float32][0][0],
        err_bf16=errs[torch.bfloat16][0][0], plan=plan and plan._asdict(), **{
            f"{k}_{dt}": val for dt, r in t.items() for k, val in r.items()})


def _k1_record(name: str, rows: list[dict]) -> dict:
    main = rows[0]   # the main path's shape
    return dict(
        name=name, route="cuda",
        source=f"{PKG}/csrc/rotate_dense.cu",
        replaces=f"{TPU_PKG}/ops/pallas/rotate_dense.py:183", launches=0,
        max_abs_err=main["err_f32"], ms=main["ms_f32"], device_ms=main["device_ms_f32"],
        plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms_f32"], bound_by=main["bound_by_f32"],
        library_ms=main["library_ms_f32"], sites=rows)


def check_kernels(batch, e_qm9: int, tag: str, rotation_only: bool = False) -> list[dict]:
    """Phase 3: K1 at the flagship's serving and QM9's training shapes, and
    its (lmax 4, mmax 4) instance at the GATA v1 preset's
    (``equiformer_v2_matpes_gata``) on the flagship's edges (f32 and bf16;
    forward, gradient and grad-of-grad through its autograd pair);
    ``rotation_only`` leaves out the tile plans."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP as cfg,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense as rd,
    )

    dev = torch.device("cuda")
    lmax, mmax, C = cfg["lmax"], cfg["mmax"], cfg["sphere_channels"]
    dvec = edge_vectors(batch)
    E = dvec.shape[0]
    K, Kr = (lmax + 1) ** 2, rd._pair_info(lmax, mmax)["n_out"]["to"]
    hv = cfg["num_heads"] * cfg["attn_value_channels"]
    gen = torch.Generator(device=dev).manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    w = rd.compute_wigner_dense(lmax, mmax, dvec)
    wq = rd.compute_wigner_dense(lmax, mmax, torch.randn(e_qm9, 3, generator=gen, device=dev))
    w44 = rd.compute_wigner_dense(lmax, lmax, dvec)
    # (kind, input shape, values and its adjoint's, site, (lmax, mmax)):
    # the flagship's attention, QM9's (baseline attention, 2C in, C back)
    # and GATA v1's at mmax = lmax (2C in at m = 0; the value path and the
    # edge-degree embedding back at full width)
    specs = [
        ("to_m0", (E, K, 2 * C), (w.v_to_m0, w.v_from_m0), "flagship attention in, m=0"),
        ("from", (E, Kr, hv), (w.v_from_res, w.v_to_res), "flagship attention back"),
        ("to", (E, K, hv), (w.v_to_res, w.v_from_res), "flagship, adjoint of from"),
        ("from_m0", (E, lmax + 1, 2 * C), (w.v_from_m0, w.v_to_m0),
         "flagship, adjoint of to_m0"),
        ("to", (e_qm9, K, 2 * C), (wq.v_to, wq.v_from), "QM9 attention in"),
        ("from", (e_qm9, Kr, C), (wq.v_from_res, wq.v_to_res), "QM9 attention back"),
        ("from", (e_qm9, Kr, 2 * C), (wq.v_from_res, wq.v_to_res), "QM9, 2C wide"),
    ]
    specs = [sp + ((lmax, mmax),) for sp in specs] + [
        ("to_m0", (E, K, 2 * C), (w44.v_to_m0, w44.v_from_m0),
         "GATA v1 attention in, m=0", (lmax, lmax)),
        ("from", (E, K, hv), (w44.v_from_res, w44.v_to_res), "GATA v1 attention back",
         (lmax, lmax)),
        ("to", (E, K, hv), (w44.v_to_res, w44.v_from_res), "GATA v1, adjoint of from",
         (lmax, lmax)),
        ("from_m0", (E, lmax + 1, 2 * C), (w44.v_from_m0, w44.v_to_m0),
         "GATA v1, adjoint of to_m0", (lmax, lmax)),
    ]
    rows = {}
    for kind, shape, (v, va), site, (lm, mm) in specs:
        suffix = "" if mm == mmax else f"[{lm},{mm}]"
        name = f"rotate_pairs.{kind}{suffix}"
        chain = site.startswith(("flagship", "GATA v1"))
        rows.setdefault(name, []).append(_k1_site(
            kind, shape, v, va, site, lm, mm, chain, gen, flush, tag, rotation_only, name))
    del w, wq, w44
    return [_k1_record(name, r) for name, r in rows.items()]


# K2's sites on the main paths: (site, grid (lmax, mmax, resolution), N, C,
# record name suffix, K2c timed).  The flagship's rows make the s2act.k*
# records (N: the serving request's padded nodes); QM9's join them as
# sites; OC20's make records of their own, named by K, and so does the
# MatPES baseline's edge site (K = 19 on the flagship's grid, E_pad 9920).
K2_SITES = [
    ("flagship FFN", (4, 4, 18), None, 512, "", True),
    ("QM9 FFN", (4, 4, None), 1152, 512, None, False),
    ("QM9 edge", (4, 2, None), 19584, 128, None, False),
    ("QM9 head", (4, 4, None), 13824, 512, None, False),
    ("OC20 node", (6, 6, None), 320, 512, "[K=49]", True),
    ("OC20 edge", (6, 2, None), 6400, 128, "[K=29]", True),
    ("MatPES baseline edge", (4, 2, 18), 9920, 128, "[base]", True),
]
# the SFU's transcendental rate: 16 per SM per clock (CUDA C++ Programming
# Guide, arithmetic throughput, compute capability 9.0) at the H100 SXM's
# 1.98 GHz boost clock
SFU_PER_SM_CLOCK, BOOST_HZ = 16, 1.98e9


def _k2_table_l2_bytes(s2act, kname: str, P: int, K: int, N: int, C: int,
                       dt: torch.dtype) -> float:
    """Bytes of tables one call reads from L2: each block reads them all.
    The kernels on the tensor cores (``s2act.tc_layout``; all three here,
    K2a / K2b only in a tree without ``TC_KERNELS``): a persistent grid of at
    most one block per SM; the FFMA kernels (K2c in such a tree, and K2a /
    K2b in a tree without ``tc_layout``): one block of 256 columns each, f32
    tables [P to 32, K to 4], A and F."""
    tc = getattr(s2act, "TC_KERNELS", ("k1", "k2") if hasattr(s2act, "tc_layout") else ())
    if kname in tc:
        L = s2act.tc_layout(K, P, dt, tc.index(kname))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks = min(sms, -(-N * (-(-C // (16 * L.mt))) // L.warps))
        return 4.0 * L.words * blocks
    return -(-N * C // 256) * 2 * 4.0 * (-(-P // 32) * 32) * (-(-K // 4) * 4)


def check_k2(n_flagship: int, tag: str, sites=K2_SITES) -> list[dict]:
    """Phase 3, K2: K2a, K2b (and K2c where ``K2_SITES`` says) against their
    plain versions at each site, f32 and bf16, and their times in both:
    CUDA events and the device-only timer.  The bound is the tensor-core
    route's (f32: 3 flops per flop at 495 TFLOP/s, 3xTF32; bf16 at 989);
    beside it the FFMA bound, the SFU floor (one transcendental per grid
    point per column) and the tables' L2 bytes.  Calls only the wrappers
    and the plain versions, whose interface is the same since K2 was
    ported, so this runs on an older checkout too (``--s2act-only``)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import s2act
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.s2grid import s2grid

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records: dict[str, dict] = {}
    for site, key, N, C, suffix, with_k3 in sites:
        N = N or n_flagship
        grid = s2grid(*key)
        A, Fm = grid.tables("cuda")
        P, K = A.shape
        # (kernel, its wrapper, plain version, inputs, outputs, products, TPU line)
        specs = [
            ("k1", lambda x, do, dd: s2act.k1(x, grid),
             lambda x, do, dd: s2act.k1_plain(x, A, Fm), 1, 1, 2, 122),
            ("k2", lambda x, do, dd: s2act.k2(x, do, grid),
             lambda x, do, dd: s2act.k2_plain(x, do, A, Fm), 2, 1, 3, 133),
        ]
        if with_k3:
            specs.append(("k3", lambda x, do, dd: s2act.k3(x, do, dd, grid),
                          lambda x, do, dd: s2act.k3_plain(x, do, dd, A, Fm), 3, 2, 5, 144))
        for kname, kern, plain, n_in, n_out, products, line in specs:
            row = dict(site=site, shape=[N, K, C], grid_points=P)
            sfu_ms = P * N * C / (SFU_PER_SM_CLOCK * sms * BOOST_HZ) * 1e3
            parts = []
            for dt, t in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                ins = [torch.randn(N, K, C, generator=gen, device=dev).to(dt)
                       for _ in range(n_in)] + [None] * (3 - n_in)
                got, want = kern(*ins), plain(*ins)
                torch.cuda.synchronize()
                pairs = zip(*(((o,) if n_out == 1 else o) for o in (got, want)))
                e = [_max_err(g_, w_, dt, f"s2act.{kname} at {site}") for g_, w_ in pairs]
                del got, want
                flops = 2.0 * products * P * K * N * C
                nbytes = dt.itemsize * (n_in + n_out) * N * K * C + 4 * 2 * A.numel()
                b_ms, b_by = (bound(nbytes, 3 * flops, "tf32") if dt == torch.float32
                              else bound(nbytes, flops, "bf16"))
                r = dict(err=max(a for a, _ in e), limit=max(b for _, b in e),
                         ms=time_ms(lambda: kern(*ins), flush),
                         device_ms=device_ms(lambda: kern(*ins), flush),
                         bound_ms=b_ms, bound_by=b_by, ffma_bound_ms=bound(nbytes, flops)[0],
                         sfu_floor_ms=sfu_ms,
                         table_l2_bytes=_k2_table_l2_bytes(s2act, kname, P, K, N, C, dt))
                r["device_bound_share"] = b_ms / r["device_ms"]
                if dt == torch.float32:
                    row["plain_ms"] = time_ms(lambda: plain(*ins), flush)
                row.update({f"{k}_{t}": v for k, v in r.items()})
                parts.append(
                    f"{t}: ms {r['ms']:.4f}, device ms {r['device_ms']:.4f}, bound "
                    f"{b_ms:.4f} ({b_by}, device {100 * r['device_bound_share']:.0f} %), FFMA "
                    f"bound {r['ffma_bound_ms']:.4f}, tables {r['table_l2_bytes'] / 1e6:.1f} MB "
                    f"from L2, err {r['err']:.2e} (limit {r['limit']:.1e})")
                del ins
            print(f"kernel s2act.{kname} {site:13s} [{N},{K},{C}] P={P}  " + "; ".join(parts)
                  + f"; plain f32 {row['plain_ms']:.4f}; SFU floor {sfu_ms:.4f}; library none  "
                  f"[{tag}]", flush=True)
            name = f"s2act.{kname}{suffix or ''}"
            if suffix is None:   # QM9: a site of the flagship's record
                records[f"s2act.{kname}"]["sites"].append(row)
                continue
            records[name] = dict(
                name=name, route="cuda", source=f"{PKG}/csrc/s2act.cu",
                replaces=f"{TPU_PKG}/ops/pallas/s2act.py:{line}", launches=0,
                max_abs_err=row["err_f32"], ms=row["ms_f32"], device_ms=row["device_ms_f32"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms_f32"],
                bound_by=row["bound_by_f32"], library_ms=None, shape=[N, K, C], grid_points=P,
                sites=[row])
    return list(records.values())


# K5's sites: (site, E, lmax, mmax, C, the dtype of the path, K5c timed,
# the record name suffix).  The flagship bf16 training step's edges (64 x 30
# atoms, fixed degree: the benchmark's training cell) and the mixed-size f32
# request's (1 x 120 + 15 x 16 atoms, ragged E_pad); both without p and
# without rl's gradient (the edge SH are detached), as the paths call them
K5_SITES = [
    ("flagship train (64 x 30)", 39680, 4, 2, 128, torch.bfloat16, True, ""),
    ("mixed request", 7296, 4, 2, 128, torch.float32, False, "[mixed]"),
]


def k5_values(kernel: str, E: int, lmax: int, mmax: int, C: int) -> int:
    """Values K5a / K5b / K5c read and write at the paths' calls (no p, no
    rl gradient, no cotangent of it): a, r, g, the kept rows of xp and rl,
    dout, the cotangents of a, r, g, xp; K5b and K5c write da, dr, dg and
    all rows of dxp, K5c also ddout."""
    S, K1 = 1 + 2 * lmax, lmax * (lmax + 2)
    w = sum(min(2 * l + 1, 2 * mmax + 1) for l in range(1, lmax + 1))
    chunks, kept, out = 3 * S * C, w * C + w, (1 + w) * C
    if kernel == "k5a":
        per = chunks + kept + out
    elif kernel == "k5b":
        per = chunks + kept + out + chunks + K1 * C
    else:
        per = chunks + kept + out + chunks + w * C + chunks + K1 * C + out
    return E * per


def check_k5(tag: str, sites=K5_SITES) -> list[dict]:
    """Phase 3, K5: K5a, K5b (and K5c where ``K5_SITES`` says) against their
    plain versions (float32, from the same inputs) at each site, f32 and
    bf16, timed with CUDA events and the device-only timer beside their
    bytes bound and the plain version's (CUDA events; in the row's dtype;
    the plain K5a is the module's eager arithmetic, K5b / K5c its
    formulas in float32)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import gata_value as gv

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records = []
    for site, E, lmax, mmax, C, path_dt, with_k5c, suffix in sites:
        S, K1 = 1 + 2 * lmax, lmax * (lmax + 2)
        kred = 1 + sum(gv.out_rows(lmax, mmax))
        need_b, need_c = (True, True, True, False, True, False), (True,) * 5 + (False, True)
        specs = [("k5a", lambda i, d, c: gv.k5a(*i, lmax, mmax),
                  lambda i, d, c: gv.k5a_plain(*i, lmax, mmax)),
                 ("k5b", lambda i, d, c: gv.k5b(*i, d, lmax, mmax, need=need_b),
                  lambda i, d, c: gv.k5b_plain(*i, d, lmax, mmax))]
        if with_k5c:
            specs.append(("k5c", lambda i, d, c: gv.k5c(*i, d, *c, lmax, mmax, need=need_c),
                          lambda i, d, c: gv.k5c_plain(*i, d, *c, lmax, mmax)))
        for kname, kern, plain in specs:
            row = dict(site=site, shape=[E, kred, C], lmax=lmax, mmax=mmax)
            parts = []
            for dt, t in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dt)  # noqa: E731
                ins = [rnd(E, S * C), rnd(E, S * C), rnd(E, S * C), None, rnd(E, K1, C),
                       rnd(E, K1)]
                dout = rnd(E, kred, C)
                cots = [rnd(E, S * C), rnd(E, S * C), rnd(E, S * C), None, rnd(E, K1, C), None]
                f32 = lambda ts: [x.float() if x is not None else None for x in ts]  # noqa: E731
                got = kern(ins, dout, cots)
                want = plain(f32(ins), dout.float(), f32(cots))
                torch.cuda.synchronize()
                pairs = [(g_, w_) for g_, w_ in zip(*(((o,) if kname == "k5a" else o)
                                                      for o in (got, want))) if g_ is not None]
                e = [_max_err(g_, w_, dt, f"gata_value.{kname} at {site}") for g_, w_ in pairs]
                del got, want
                b_ms, b_by = bound(dt.itemsize * k5_values(kname, E, lmax, mmax, C), 0.0)
                r = dict(err=max(a for a, _ in e), limit=max(b for _, b in e),
                         ms=time_ms(lambda: kern(ins, dout, cots), flush),
                         device_ms=device_ms(lambda: kern(ins, dout, cots), flush),
                         plain_ms=time_ms(lambda: plain(ins, dout, cots), flush),
                         bound_ms=b_ms, bound_by=b_by)
                r["device_bound_share"] = b_ms / r["device_ms"]
                row.update({f"{k}_{t}": v for k, v in r.items()})
                parts.append(
                    f"{t}: ms {r['ms']:.4f}, device ms {r['device_ms']:.4f}, bound {b_ms:.4f} "
                    f"({b_by}, device {100 * r['device_bound_share']:.0f} %), plain ms "
                    f"{r['plain_ms']:.4f}, err {r['err']:.2e} (limit {r['limit']:.1e})")
                del ins, dout, cots
            print(f"kernel gata_value.{kname} {site} [{E},{kred},{C}]  " + "; ".join(parts)
                  + f"  [{tag}]", flush=True)
            t = "bf16" if path_dt == torch.bfloat16 else "f32"
            name = f"gata_value.{kname}{suffix}"
            records.append(dict(
                name=name, route="cuda", source=f"{PKG}/csrc/gata_value.cu",
                replaces=None, launches=0, max_abs_err=row[f"err_{t}"], ms=row[f"ms_{t}"],
                device_ms=row[f"device_ms_{t}"], plain_ms=row[f"plain_ms_{t}"],
                bound_ms=row[f"bound_ms_{t}"], bound_by=row[f"bound_by_{t}"], library_ms=None,
                shape=[E, kred, C], dtype=t, sites=[row]))
    return records


def _k3_gradgrad(x, ws, cout, extra, plain: bool):
    """Gradients (x, every W) of |d/dx (|y|^2 + |extra|^2) / 2|^2 through
    K3 (kernel chain: fwd, adj, fwd, adj) or through autograd of the plain
    version."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        so2conv as k3,
    )

    x = x.detach().requires_grad_(True)
    ws = [w.detach().requires_grad_(True) for w in ws]
    conv = k3.fwd_plain if plain else k3.so2conv_fused
    y, ex = conv(x, ws, 4, 2, cout, extra)
    inner = 0.5 * y.float().square().sum()
    if extra:
        inner = inner + 0.5 * ex.float().square().sum()
    (gx,) = torch.autograd.grad(inner, x, create_graph=True)
    return torch.autograd.grad(gx.float().square().sum(), [x, *ws])


def check_k3_b_operands(ws, flush, tag: str) -> dict:
    """K3's B operands (the forward's W_g^T split into TF32 big and small
    parts, one launch per group) against the plain version, bit for bit,
    and their times, at the weights ``ws`` (float32)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        so2conv as k3,
    )

    got, want = k3.b_operands(ws, False), k3.b_operands_plain(ws, False)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got[0] + got[1], want[0] + want[1]))
    if err != 0.0:
        raise RuntimeError(f"so2conv.b_operands: max abs err {err:.3e} (must be 0)")
    ms = time_ms(lambda: k3.b_operands(ws, False), flush)
    dev_ms = device_ms(lambda: k3.b_operands(ws, False), flush)
    plain_ms = time_ms(lambda: k3.b_operands_plain(ws, False), flush)
    b_ms, b_by = bound(3 * 4 * sum(w.numel() for w in ws), 0.0)   # read W, write big, small
    print(f"kernel so2conv.b_operands QM9 conv 1 weights {[list(w.shape) for w in ws]} f32: "
          f"ms {ms:.4f}, device ms {dev_ms:.4f} ({len(ws)} launches)  plain {plain_ms:.4f}  "
          f"bound {b_ms:.4f} ({b_by})  "
          f"library none  err {err:.1e} (bit for bit)  [{tag}]", flush=True)
    return dict(name="so2conv.b_operands", route="cuda", source=f"{PKG}/csrc/so2conv.cu",
                replaces=f"{TPU_PKG}/ops/pallas/so2conv.py:323", launches=0, max_abs_err=err,
                ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_k3(e_flagship: int, e_qm9: int, tag: str) -> list[dict]:
    """Phase 3, K3: forward, adjoint and grad-of-grad against the plain
    versions at three sites, f32 and bf16; times at each site in both.

    The kernel runs f32 as 3xTF32 on the tensor cores, so its bound is the
    larger of bytes / 3.35 TB/s and 3 flops / 495 TFLOP/s; bf16 runs bf16
    products, flops / 989 TFLOP/s.  The FFMA bound (flops / 67 TFLOP/s) of
    the earlier FFMA kernel is printed beside it.  The library is the three
    cuBLAS GEMMs of the site on inputs already permuted, f32 with TF32 off."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.nn.so3_layers import SO2Conv
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        so2conv as k3,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.irreps import layout

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    groups = k3._row_maps(4, 2)
    idx = [torch.as_tensor(r, device=dev) for r in groups]
    K = sum(map(len, groups))
    sites = [("QM9 conv 1", e_qm9, 256, 128, 384), ("QM9 conv 2", e_qm9, 128, 128, 0),
             ("flagship conv 2", e_flagship, 128, 128, 0)]
    rows = {"fwd": [], "adj": []}
    for site, E, cin, cout, extra in sites:
        def operands(dt):
            ws = [(torch.randn(len(r) * cin, (extra if g == 0 else 0) + len(r) * cout,
                               generator=gen, device=dev) / (len(r) * cin) ** 0.5).to(dt)
                  for g, r in enumerate(groups)]
            x = torch.randn(E, K, cin, generator=gen, device=dev).to(dt)
            dy = torch.randn(E, K, cout, generator=gen, device=dev).to(dt)
            dex = torch.randn(E, extra, generator=gen, device=dev).to(dt) if extra else None
            return ws, x, dy, dex

        errs = {"fwd": {}, "adj": {}, "gradgrad": {}}
        for dt in (torch.float32, torch.bfloat16):
            ws, x, dy, dex = operands(dt)
            got = k3.fwd(x, ws, 4, 2, cout, extra)
            want = k3.fwd_plain(x, ws, 4, 2, cout, extra)
            pairs = {"fwd": list(zip(got, want))[: 2 if extra else 1],
                     "adj": [(k3.adj(dy, dex, ws, 4, 2, cin),
                              k3.adj_plain(dy, dex, ws, 4, 2, cin))],
                     "gradgrad": list(zip(_k3_gradgrad(x, ws, cout, extra, False),
                                          _k3_gradgrad(x, ws, cout, extra, True)))}
            torch.cuda.synchronize()
            for what, ps in pairs.items():
                e = [_max_err(g_, w_, dt, f"so2conv {what} at {site}") for g_, w_ in ps]
                errs[what][dt] = (max(a for a, _ in e), max(b for _, b in e))
            if dt == torch.float32:   # kernel and plain (cuBLAS f32) against float64
                wsd = [w.double() for w in ws]
                ref = {"fwd": k3.fwd_plain(x.double(), wsd, 4, 2, cout, extra)[: 2 if extra else 1],
                       "adj": [k3.adj_plain(dy.double(), None if dex is None else dex.double(),
                                            wsd, 4, 2, cin)]}
                for what, r in ref.items():
                    kernel_out, plain_out = zip(*pairs[what])
                    errs[what]["f64"] = tuple(
                        max(((o.double() - r_).abs().max() / r_.abs().max()).item()
                            for o, r_ in zip(outs, r))
                        for outs in (kernel_out, plain_out))
                del wsd, ref
        flops = 2.0 * E * sum(w.numel() for w in ws)
        timed = {"fwd": {}, "adj": {}}
        for dt in (torch.float32, torch.bfloat16):
            ws, x, dy, dex = operands(dt)
            # cuBLAS on inputs already in the GEMM layout (the library yardstick)
            xg = [x.index_select(1, r).reshape(E, -1).contiguous() for r in idx]
            dyg = [k3._group_rows(dy, dex if g == 0 else None, r).contiguous()
                   for g, r in enumerate(idx)]
            n = dt.itemsize
            wbytes = n * sum(w.numel() for w in ws)
            runs = {
                "fwd": (lambda: k3.fwd(x, ws, 4, 2, cout, extra),
                        lambda: [a @ w for a, w in zip(xg, ws)],
                        n * (x.numel() + E * K * cout + E * extra) + wbytes),
                "adj": (lambda: k3.adj(dy, dex, ws, 4, 2, cin),
                        lambda: [a @ w.t() for a, w in zip(dyg, ws)],
                        n * (dy.numel() + E * extra + E * K * cin) + wbytes),
            }
            for kind, (kern, lib, nbytes) in runs.items():
                if dt == torch.float32:
                    b_ms, b_by = bound(nbytes, 3 * flops, "tf32")
                    timed[kind].update(ms=time_ms(kern, flush), device_ms=device_ms(kern, flush),
                                       library_ms=time_ms(lib, flush),
                                       bound_ms=b_ms, bound_by=b_by,
                                       ffma_bound_ms=bound(nbytes, flops)[0])
                else:
                    b_ms, b_by = bound(nbytes, flops, "bf16")
                    timed[kind].update(bf16_ms=time_ms(kern, flush),
                                       bf16_device_ms=device_ms(kern, flush),
                                       bf16_library_ms=time_ms(lib, flush),
                                       bf16_bound_ms=b_ms, bf16_bound_by=b_by)
            if dt == torch.float32 and site == sites[0][0]:
                b_record = check_k3_b_operands(ws, flush, tag)
            if dt == torch.float32:
                timed["fwd"]["plain_ms"] = time_ms(
                    lambda: k3.fwd_plain(x, ws, 4, 2, cout, extra), flush)
                timed["adj"]["plain_ms"] = time_ms(
                    lambda: k3.adj_plain(dy, dex, ws, 4, 2, cin), flush)
                # the port's unfused SO2Conv of the same site (no radial weights)
                conv = SO2Conv(layout(4, 2), cin, cout, extra_m0=extra).to(dev)
                conv.requires_grad_(False)
                with torch.no_grad():
                    conv.w_m0.copy_(ws[0])
                    for m in (1, 2):
                        n_in, n_out = ws[m].shape[0] // 2, ws[m].shape[1] // 2
                        getattr(conv, f"w_m{m}_r").copy_(ws[m][:n_in, :n_out])
                        getattr(conv, f"w_m{m}_i").copy_(ws[m][:n_in, n_out:])
                xr = x.clone().requires_grad_(True)
                y_un, ex_un = conv(xr)
                outs_un = [y_un] + ([ex_un] if extra else [])
                cots_un = [dy] + ([dex] if extra else [])
                timed["fwd"]["unfused_ms"] = time_ms(lambda: conv(x), flush)
                timed["adj"]["unfused_ms"] = time_ms(lambda: torch.autograd.grad(
                    outs_un, xr, cots_un, retain_graph=True), flush)
                del conv, y_un, ex_un, outs_un, xr
            del xg, dyg
        for kind, t in timed.items():
            rows[kind].append(dict(
                site=site, shape=[E, K, cin if kind == "fwd" else cout], **t,
                err_f32=errs[kind][torch.float32][0], err_bf16=errs[kind][torch.bfloat16][0],
                rel_err_f64=errs[kind]["f64"][0], plain_rel_err_f64=errs[kind]["f64"][1],
                gradgrad_err_f32=errs["gradgrad"][torch.float32][0],
                gradgrad_err_bf16=errs["gradgrad"][torch.bfloat16][0]))
            print(f"kernel so2conv.{kind:4s} {site:16s} E {E} Cin {cin} Cout {cout} extra "
                  f"{extra}: f32 ms {t['ms']:.4f}  device ms {t['device_ms']:.4f}  plain "
                  f"{t['plain_ms']:.4f}  bound "
                  f"{t['bound_ms']:.4f} ({t['bound_by']}; 3xTF32 at 495 TFLOP/s)  FFMA bound "
                  f"{t['ffma_bound_ms']:.4f}  library(3 cuBLAS GEMMs, allow_tf32=False) "
                  f"{t['library_ms']:.4f}  unfused SO2Conv {t['unfused_ms']:.4f}  |  bf16 ms "
                  f"{t['bf16_ms']:.4f}  device ms {t['bf16_device_ms']:.4f}  bound "
                  f"{t['bf16_bound_ms']:.4f} ({t['bf16_bound_by']})  "
                  f"library(3 cuBLAS bf16 GEMMs) {t['bf16_library_ms']:.4f}  |  err f32 "
                  f"{errs[kind][torch.float32][0]:.2e} (limit {errs[kind][torch.float32][1]:.1e}) "
                  f"bf16 {errs[kind][torch.bfloat16][0]:.2e} (limit "
                  f"{errs[kind][torch.bfloat16][1]:.1e}); f32 against float64, relative to "
                  f"max|float64|: kernel {errs[kind]['f64'][0]:.2e}, plain (cuBLAS f32) "
                  f"{errs[kind]['f64'][1]:.2e}  [{tag}]", flush=True)
        print(f"kernel so2conv grad-of-grad {site}: err f32 "
              f"{errs['gradgrad'][torch.float32][0]:.2e} (limit "
              f"{errs['gradgrad'][torch.float32][1]:.1e}) bf16 "
              f"{errs['gradgrad'][torch.bfloat16][0]:.2e} (limit "
              f"{errs['gradgrad'][torch.bfloat16][1]:.1e})  [{tag}]", flush=True)
    records = []
    for kind, line in (("fwd", 111), ("adj", 140)):
        main = rows[kind][0]   # QM9 conv 1, the largest site of the main path
        records.append(dict(
            name=f"so2conv.{kind}", route="cuda", source=f"{PKG}/csrc/so2conv.cu",
            replaces=f"{TPU_PKG}/ops/pallas/so2conv.py:{line}", launches=0,
            max_abs_err=main["err_f32"], ms=main["ms"], device_ms=main["device_ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], ffma_bound_ms=main["ffma_bound_ms"],
            bf16_ms=main["bf16_ms"], bf16_device_ms=main["bf16_device_ms"],
            bf16_bound_ms=main["bf16_bound_ms"],
            bf16_library_ms=main["bf16_library_ms"], unfused_ms=main["unfused_ms"],
            sites=rows[kind]))
    return records + [b_record]


def _flagship_batches(n: int, seed: int = 2, structures: int = N_STRUCTURES,
                      layout: str = "fixed") -> list[dict]:
    """``n`` labelled batches of ``structures`` x ``N_ATOMS`` on the card, in
    the flagship's fixed-degree layout (16 structures: N_pad 496, E_pad
    9920), ragged (N_pad as the fixed-degree batch's, E_pad the most edges
    ``MAX_NEIGHBORS`` allows rounded up to 128, the serving request's
    quantum: 9728 for 16 x 30) or uniform (phase 18's per-graph slots: 640
    / 12,288); the same structures in every layout."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import bucket
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )

    rng = np.random.default_rng(seed)
    n_pad, e_pad = fixed_degree_pads([N_ATOMS] * structures, MAX_NEIGHBORS)
    pads = {"fixed": (n_pad, e_pad, dict(fixed_degree=True)),
            "ragged": (n_pad, bucket(structures * N_ATOMS * MAX_NEIGHBORS + 1, 128), {}),
            "uniform": (structures * UNIFORM_SLOTS[0], structures * UNIFORM_SLOTS[1],
                        dict(uniform=True))}[layout]
    batches = []
    for _ in range(n):
        pb = collate(labelled_structures(rng, structures, N_ATOMS), CUTOFF,
                     MAX_NEIGHBORS, pads[0], pads[1], **pads[2])
        if pb.overflow_atoms or pb.overflow_edges:
            raise RuntimeError("training batch overflowed its pads")
        batches.append(as_tensors(pb, "cuda"))
    return batches


def _train_state(model, w_stress: float = 0.0):
    """The flagship step's optimizer and EMA (bench.py:308-359) around a
    model on the card; returns the state and its step."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.schedules import (
        warmup_cosine,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        make_matpes_train_step,
    )

    opt = GuardedAdamW(model.named_parameters(), warmup_cosine(2e-4, 100, 10000), 1e-3, 1.0)
    state = create_train_state(model, opt)
    return state, make_matpes_train_step(state, w_stress=w_stress,
                                         generator=torch.Generator("cuda").manual_seed(0))


def _timed_steps(step, counters: dict, what: str, tag: str,
                 n_timed: int = N_TRAIN_STEPS) -> dict:
    """``N_WARMUP_STEPS`` + ``n_timed`` steps of ``step`` on flagship
    batches, the launch counts zeroed just before the timed steps; fails if
    a loss (or a stress term the step reports) is not finite, the guard
    skipped a step, or a kernel of ``counters`` was never launched."""
    batches = _flagship_batches(N_WARMUP_STEPS + n_timed)
    print(f"training: {what}, {N_STRUCTURES} structures x {N_ATOMS} atoms, N_pad "
          f"{batches[0]['pos'].shape[0]}, E_pad {batches[0]['edge_src'].shape[0]}, AdamW wd "
          f"1e-3, warmup_cosine(2e-4, 100, 10000), EMA 0.999  [{tag}]", flush=True)

    def run(i, batch):
        before = {n: d[k] for n, (d, k) in counters.items()}
        t = time.perf_counter()
        loss, m = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        loss = float(loss)
        stress = f", stress {float(m['stress_l1']):.4f}" if "stress_l1" in m else ""
        if not (np.isfinite(loss) and m["accepted"]
                and np.isfinite(float(m.get("stress_l1", 0.0)))):
            raise RuntimeError(f"{what} step {i}: loss {loss}{stress}, accepted {m['accepted']}")
        per = {n: d[k] - before[n] for n, (d, k) in counters.items()}
        print(f"train step {i}: {dt * 1e3:.1f} ms, {N_STRUCTURES / dt:.1f} graphs/s, "
              f"loss {loss:.4f} (E {float(m['energy_l1']):.4f}, F {float(m['force_l1']):.4f}"
              f"{stress}), |g| {float(m['grad_norm']):.3f}, lr {m['lr']:.3e}, launches {per}  "
              f"[{tag}]", flush=True)
        return dt

    for i in range(N_WARMUP_STEPS):
        run(f"warm-up {i}", batches[i])
    for d, k in counters.values():
        d[k] = 0
    torch.cuda.reset_peak_memory_stats()
    times = [run(i, b) for i, b in enumerate(batches[N_WARMUP_STEPS:])]
    launches = {n: d[k] for n, (d, k) in counters.items()}
    med = float(np.median(times))
    print(f"training: {what}: median step {med * 1e3:.1f} ms ({min(times) * 1e3:.1f}-"
          f"{max(times) * 1e3:.1f}), {N_STRUCTURES / med:.1f} graphs/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches per step "
          f"{ {n: c / n_timed for n, c in launches.items()} }  [{tag}]", flush=True)
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the {what} path: {idle}")
    return launches


def train_phase(counters: dict, tag: str) -> dict:
    """Phase 6: the flagship bf16 force-training step (bench.py:308-359)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )

    model = EquiformerV2MatPES(**FLAGSHIP, alpha_drop=0.0, drop_path_rate=0.0,
                               compute_dtype=torch.bfloat16, **FIXED_DEGREE)
    init_weights(model, torch.Generator().manual_seed(0)).to("cuda")
    _, step = _train_state(model)
    return _timed_steps(step, counters, "flagship bf16 step", tag)


def train_parity_phase(tag: str) -> None:
    """Phase 7: one f32 step, 2 layers at the flagship widths, 2 structures,
    on the card and on the CPU plain path from the same weights: loss and
    gradients must agree (gradients after the step's clip; each device
    scales by its own norm).  The update is then held on identical
    gradients: the card's clipped gradients go through the guarded AdamW and
    the EMA on the CPU, and every parameter and EMA entry must agree with
    the card's to 1e-2 lr.  (From the two devices' own gradients it could
    not: Adam's first update lr g / (|g| + eps) is sign-like where |g| is
    near eps, so a float32 difference in g moves such an entry by up to
    2 lr.)  The learning rate is the schedule's peak, 2e-4, so that 1e-2 lr
    lies well above one float32 ulp of the weights."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        ema_update,
        make_matpes_train_step,
    )

    lr = 2e-4
    cfg = dict(FLAGSHIP, num_layers=2, alpha_drop=0.0, drop_path_rate=0.0, **FIXED_DEGREE)
    weights = init_weights(EquiformerV2MatPES(**cfg), torch.Generator().manual_seed(3))
    weights = {k: v.clone() for k, v in weights.state_dict().items()}
    samples = labelled_structures(np.random.default_rng(3), 2, N_ATOMS)
    n_pad, e_pad = fixed_degree_pads([N_ATOMS] * 2, MAX_NEIGHBORS)
    pb = collate(samples, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, fixed_degree=True)

    def train_state(dev):
        model = EquiformerV2MatPES(**cfg)
        model.load_state_dict(weights)
        model.to(dev)
        return create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                      lambda step: lr, 1e-3, 1.0))

    res = {}
    for dev in ("cuda", "cpu"):
        state = train_state(dev)
        loss, m = make_matpes_train_step(state)(as_tensors(pb, dev))
        named = list(state.model.named_parameters())
        res[dev] = dict(
            loss=float(loss), gnorm=float(m["grad_norm"]),
            grads={n: p.grad.detach().cpu() for n, p in named},
            params={n: p.detach().cpu() for n, p in named},
            ema={n: e.cpu() for n, e in state.ema.items()})
    g, c = res["cuda"], res["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    num = sum(float(((g["grads"][k].double() - c["grads"][k].double()) ** 2).sum())
              for k in c["grads"])
    den = sum(float((c["grads"][k].double() ** 2).sum()) for k in c["grads"])
    grad_rel = (num / den) ** 0.5
    # the CPU's update from the card's clipped gradients (re-clipping them
    # scales by 1 to within a float32 rounding)
    replay = train_state("cpu")
    for n, p in replay.model.named_parameters():
        p.grad = g["grads"][n].clone()
    if not replay.optimizer.step()["accepted"]:
        raise RuntimeError("the card's gradients are not finite")
    ema_update(replay.ema, replay.model)
    want = dict(replay.model.named_parameters())
    dp = max(float((g["params"][k] - want[k].detach()).abs().max()) for k in want)
    de = max(float((g["ema"][k] - replay.ema[k]).abs().max()) for k in want)
    n_all = sum(v.numel() for v in want.values())
    print(f"gpu vs cpu plain path, one f32 training step (2 layers, 2 structures): "
          f"loss {g['loss']:.6f} vs {c['loss']:.6f}, rel err {loss_rel:.2e} (limit 1e-4); "
          f"|g| {g['gnorm']:.4f} vs {c['gnorm']:.4f}, gradient rel L2 err {grad_rel:.2e} "
          f"(limit 1e-3); on the card's gradients, all {n_all} entries after the step: "
          f"params max |diff| {dp:.2e}, EMA {de:.2e} (limit {1e-2 * lr:.1e} = 1e-2 lr)  "
          f"[{tag}]", flush=True)
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3 and dp <= 1e-2 * lr and de <= 1e-2 * lr):
        raise RuntimeError("the training step on the card disagrees with the CPU plain path")


def qm9_phase(counters: dict, tag: str) -> tuple[dict, dict]:
    """Phase 8: the QM9 step with K3 (and the composed A/B without it), and
    3 evaluation requests.  Returns the launches of the timed K3 steps and
    of the requests."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_qm9 import (
        predict,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        qm9_batch,
        qm9_train_state,
    )

    rng = np.random.default_rng(5)
    pbs = [qm9_batch(rng, QM9_MOLECULES, QM9_ATOMS)
           for _ in range(N_WARMUP_STEPS + N_TRAIN_STEPS + N_REQUESTS)]
    batches = [as_tensors(pb, "cuda") for pb in pbs]
    train, requests = batches[:-N_REQUESTS], batches[-N_REQUESTS:]
    arms = {on: qm9_train_state(conv_fused=on) for on in (True, False)}
    n_pad, e_pad = pbs[0].pos.shape[0], pbs[0].edge_src.shape[0]
    print(f"QM9: full-width EquiformerV2QM9 (8 layers, 128 channels, lmax 4 / mmax 2, "
          f"8 heads, FFN 512, 600 RBF, default S2 grid), f32, {QM9_MOLECULES} molecules x "
          f"{QM9_ATOMS} atoms, N_pad {n_pad}, E_pad {e_pad} "
          f"({int(pbs[0].edge_mask.sum())} real edges), AdamW lr 5e-4 wd 5e-3, EMA 0.999, "
          f"dropouts of configs/qm9.py  [{tag}]", flush=True)

    def run(on: bool, i, batch):
        before = {n: d[k] for n, (d, k) in counters.items()}
        t = time.perf_counter()
        loss, m = arms[on][1](batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        loss = float(loss)
        if not (np.isfinite(loss) and m["accepted"]):
            raise RuntimeError(f"QM9 step {i} (conv_fused {on}): loss {loss}, "
                               f"accepted {m['accepted']}")
        per = {n: d[k] - before[n] for n, (d, k) in counters.items()}
        print(f"QM9 step {i} conv_fused {'on ' if on else 'off'}: {dt * 1e3:.1f} ms, "
              f"{QM9_MOLECULES / dt:.1f} molecules/s, loss {loss:.4f}, "
              f"|g| {float(m['grad_norm']):.3f}, launches {per}  [{tag}]", flush=True)
        return dt

    for on in (True, False):
        for i in range(N_WARMUP_STEPS):
            run(on, f"warm-up {i}", train[i])
    timed = train[N_WARMUP_STEPS:]
    times = {True: [], False: []}
    peak = {}
    for block, on in enumerate((True, False, False, True)):   # in turns: A B B A
        if block < 2:
            torch.cuda.reset_peak_memory_stats()
        if block == 0:
            for d, k in counters.values():
                d[k] = 0
        times[on] += [run(on, i, b) for i, b in enumerate(timed)]
        if block == 0:
            launches = {n: d[k] for n, (d, k) in counters.items()}
        if block < 2:
            peak[on] = torch.cuda.max_memory_allocated() / 2**30
    for on in (True, False):
        med = float(np.median(times[on]))
        print(f"QM9 training, conv_fused {'on ' if on else 'off'}: median step "
              f"{med * 1e3:.1f} ms ({min(times[on]) * 1e3:.1f}-{max(times[on]) * 1e3:.1f} over "
              f"{len(times[on])} steps in two blocks), {QM9_MOLECULES / med:.1f} molecules/s, "
              f"peak memory {peak[on]:.3f} GiB  [{tag}]", flush=True)
    print(f"QM9 composed A/B: step with K3 / without = "
          f"{np.median(times[True]) / np.median(times[False]):.3f}; launches per step "
          f"with K3 {({n: c / N_TRAIN_STEPS for n, c in launches.items()})}  [{tag}]",
          flush=True)
    idle = [n for n, c in launches.items() if c == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the QM9 training path: {idle}")
    qm9_bf16_step(counters, train, tag)

    state = arms[True][0]
    del arms[False]
    for d, k in counters.values():
        d[k] = 0
    for i, batch in enumerate(requests):
        t = time.perf_counter()
        pred = predict(state.model, batch, state.ema)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if pred.shape != (QM9_MOLECULES, 12) or not torch.isfinite(pred).all():
            raise RuntimeError(f"QM9 request {i}: bad predictions of shape {tuple(pred.shape)}")
        print(f"QM9 request {i}: {QM9_MOLECULES} molecules, {dt * 1e3:.1f} ms, "
              f"{QM9_MOLECULES / dt:.1f} molecules/s  [{tag}]", flush=True)
    eval_launches = {n: d[k] for n, (d, k) in counters.items()}
    print(f"launches over {N_REQUESTS} QM9 requests: {eval_launches}  [{tag}]", flush=True)
    return launches, eval_launches


def qm9_bf16_step(counters: dict, batches: list[dict], tag: str) -> dict:
    """Phase 8's bf16 QM9 step (bf16 compute, f32 masters, K3 on) on the f32
    steps' batches: CUDA-event ms (median of the timed steps after the
    warm-ups), peak device memory over them, launches per step; fails if a
    loss is not finite, the guard skipped a step or a kernel of the path
    never launched."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        qm9_train_state,
    )

    state, step = qm9_train_state(conv_fused=True, compute_dtype=torch.bfloat16)
    for b in batches[:N_WARMUP_STEPS]:
        step(b)
    torch.cuda.synchronize()
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    timed, losses = iter(batches[N_WARMUP_STEPS:]), []
    ms = _event_ms(lambda: losses.append(step(next(timed))), len(batches) - N_WARMUP_STEPS)
    n = len(ms)
    rec = dict(step_ms=float(np.median(ms)), step_ms_min=min(ms), step_ms_max=max(ms),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: d[c] / n for k, (d, c) in counters.items()})
    print(f"QM9 training, bf16 (f32 masters), conv_fused on: median step {rec['step_ms']:.2f} "
          f"ms (CUDA events, {n} steps after {N_WARMUP_STEPS} warm-ups; "
          f"{rec['step_ms_min']:.2f}-{rec['step_ms_max']:.2f}), "
          f"{QM9_MOLECULES / rec['step_ms'] * 1e3:.1f} molecules/s, peak memory "
          f"{rec['peak_gib']:.3f} GiB, launches per step {rec['launches']}  [{tag}]",
          flush=True)
    bad = [i for i, (loss, m) in enumerate(losses)
           if not (np.isfinite(float(loss)) and m["accepted"])]
    idle = [k for k, c in rec["launches"].items() if c == 0]
    if bad or idle:
        raise RuntimeError(f"QM9 bf16 steps {bad} not finite or skipped; kernels never "
                           f"launched {idle}")
    del state, step
    return rec


def qm9_parity_phase(tag: str) -> None:
    """Phase 9: one f32 QM9 step (conv_fused on, dropout off), 2 layers at
    full width, 8 molecules, on the card and on the CPU plain path from the
    same weights: loss <= 1e-4 relative, gradients (after each device's own
    clip) <= 1e-3 relative L2."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs.qm9 import config
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_qm9 import (
        build_model,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        make_qm9_train_step,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        qm9_batch,
    )

    cfg = dict(config, num_layers=2, alpha_drop=0.0, drop_path_rate=0.0, conv_fused=True)
    weights = init_weights(build_model(cfg), torch.Generator().manual_seed(4)).state_dict()
    pb = qm9_batch(np.random.default_rng(6), 8, QM9_ATOMS)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg)
        model.load_state_dict(weights)
        model.to(dev)
        state = create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                       lambda step: 5e-4, 5e-3, 1.0))
        loss, m = make_qm9_train_step(state)(as_tensors(pb, dev))
        res[dev] = dict(loss=float(loss), gnorm=float(m["grad_norm"]),
                        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    g, c = res["cuda"], res["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    num = sum(float(((g["grads"][k].double() - c["grads"][k].double()) ** 2).sum())
              for k in c["grads"])
    den = sum(float((c["grads"][k].double() ** 2).sum()) for k in c["grads"])
    grad_rel = (num / den) ** 0.5
    print(f"QM9 gpu vs cpu plain path, one f32 training step (2 layers, full width, "
          f"8 molecules, conv_fused on): loss {g['loss']:.6f} vs {c['loss']:.6f}, rel err "
          f"{loss_rel:.2e} (limit 1e-4); |g| {g['gnorm']:.4f} vs {c['gnorm']:.4f}, gradient "
          f"rel L2 err {grad_rel:.2e} (limit 1e-3)  [{tag}]", flush=True)
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3):
        raise RuntimeError("the QM9 training step on the card disagrees with the CPU plain path")


def k4_macs(segments, C: int) -> int:
    """Multiply-adds per edge of K4 as csrc/rotate.cu does them: the block
    build (per degree l, d = 2l + 1: H's d x in_w entries at 2 each; per
    pair of flipped output rows, both rows of G at 2 per entry, both rows
    of G H and both of M at 2 per entry) and the apply (in_w x out_w per
    channel)."""
    macs = 0
    for l, (_, iw, _, ow) in enumerate(segments):
        d = 2 * l + 1
        macs += 2 * d * iw + (ow + 1) // 2 * (4 * d + 2 * d * iw + 4 * iw) + iw * ow * C
    return macs


def check_k4(flagship_vec: torch.Tensor, oc20_vec: torch.Tensor, tag: str,
             rotation_only: bool = False) -> list[dict]:
    """Phase 3, K4: each kind against rot_plain in f32 and bf16, first order
    and grad-of-grad through the autograd pair against the plain chain, and
    times at OC20's and the flagship's shapes (f32 and bf16; the tile plans
    not with ``rotation_only``)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import rotation as rot
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate as k4,
        rotate_dense as rd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # (kind, (lmax, mmax), edge vectors, channels, site): OC20's attention
    # (C = 128: in 2C, back 8 heads x 16) and the flagship's GATA attention
    specs = [("to", (6, 2), oc20_vec, 256, "OC20 attention in"),
             ("from", (6, 2), oc20_vec, 128, "OC20 attention back"),
             ("to_m0", (4, 2), flagship_vec, 256, "flagship attention in, m = 0"),
             ("from_m0", (4, 2), flagship_vec, 256, "flagship, adjoint of to_m0"),
             ("from", (4, 2), flagship_vec, 128, "flagship attention back")]
    rows = {}
    for kind, (lmax, mmax), vec, C, site in specs:
        E = vec.shape[0]
        w = rot.compute_wigner(lmax, vec)
        ts, ta = k4.tables(w, lmax, mmax, kind)
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(E, ts[0].shape[1], C, generator=gen, device=dev).to(dt)
            e_fwd = _max_err(k4.rot_kernel(x, ts, lmax, mmax, kind), k4.rot_plain(x, ts), dt,
                             f"rotate.{kind} at {site}")
            xg = x.clone().requires_grad_(True)
            y = k4.rotate(w, xg, lmax, mmax, kind)   # through the autograd pair
            (gx,) = torch.autograd.grad(0.5 * y.float().square().sum(), xg, create_graph=True)
            (gg,) = torch.autograd.grad(gx.float().square().sum(), xg)
            P = k4.rot_plain
            gx_ref = P(P(x, ts), ta)
            gg_ref = 2 * P(P(P(P(x, ts), ta), ts), ta)
            e_g = _max_err(gx.detach(), gx_ref, dt, f"rotate.{kind} gradient at {site}")
            e_gg = _max_err(gg, gg_ref, dt, f"rotate.{kind} grad-of-grad at {site}")
            errs[dt] = (e_fwd, e_g, e_gg)
        torch.cuda.synchronize()
        x = torch.randn(E, ts[0].shape[1], C, generator=gen, device=dev)
        # library: torch.bmm with the per-edge dense Wigner of the same rotation
        wd = rd.compute_wigner_dense(lmax, mmax, vec)
        v = {"to": wd.v_to, "from": wd.v_from_res, "to_m0": wd.v_to_m0,
             "from_m0": wd.v_from_m0}[kind]
        info = rd._pair_info(lmax, mmax)
        pairs = info["pairs"][kind]
        n_out = info["n_out"][kind]
        dense = _dense_wigner(E, n_out, x.shape[1], pairs, v)
        torch.testing.assert_close(torch.bmm(dense, x), k4.rot_plain(x, ts), rtol=1e-4,
                                   atol=1e-4 * x.abs().max().item())
        t = time_rotation(lambda a: k4.rot_kernel(a, ts, lmax, mmax, kind), x, dense, n_out,
                          4 * sum(a.numel() for a in ts[:6]),
                          2.0 * k4_macs(k4.kernel_segments(lmax, mmax, kind), C) * E, flush)
        plain_ms = time_ms(lambda: k4.rot_plain(x, ts), flush)
        plan = None if rotation_only else _plan("rot_plan", lmax, mmax, kind, C)
        err_txt = ", ".join(
            f"{'f32' if dt == torch.float32 else 'bf16'} "
            + " / ".join(f"{e:.2e} ({lim:.1e})" for e, lim in errs[dt])
            for dt in errs) + " (fwd / grad / gradgrad)"
        _rotation_line(f"rotate.{kind}", site, list(x.shape), [E, n_out, C], t, plain_ms, plan,
                       err_txt, tag)
        row = dict(site=site, lmax=lmax, mmax=mmax, shape=[E, x.shape[1], C],
                   out_shape=[E, n_out, C], plain_ms=plain_ms, err_f32=errs[torch.float32][0][0],
                   err_bf16=errs[torch.bfloat16][0][0],
                   grad_err_f32=errs[torch.float32][1][0],
                   gradgrad_err_f32=errs[torch.float32][2][0],
                   gradgrad_err_bf16=errs[torch.bfloat16][2][0], plan=plan and plan._asdict(),
                   **{f"{k}_{dt}": val for dt, r in t.items() for k, val in r.items()})
        rows.setdefault(kind, []).append(row)
        del dense, x, w, wd
    records = []
    for kind in k4.KINDS:
        main = rows[kind][0]   # the first site listed: the main path's shape
        records.append(dict(
            name=f"rotate.{kind}", route="cuda", source=f"{PKG}/csrc/rotate.cu",
            replaces=f"{TPU_PKG}/ops/pallas/rotate.py:66", launches=0,
            max_abs_err=main["err_f32"], ms=main["ms_f32"], device_ms=main["device_ms_f32"],
            plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms_f32"], bound_by=main["bound_by_f32"],
            library_ms=main["library_ms_f32"], sites=rows[kind]))
    return records


def factored_request_phase(pred, state: dict, request, tag: str) -> dict:
    """Phase 4b: the flagship request on the factored Wigner representation
    (kernel K4) with the dense run's weights; returns K4's launches."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import rotate as k4

    dense = pred.predict_batch(request)
    fact = Predictor(EquiformerV2MatPES(**FLAGSHIP, wigner_rep="factored"), state, CUTOFF,
                     MAX_NEIGHBORS, device="cuda")
    for k in k4.launches:
        k4.launches[k] = 0
    t = time.perf_counter()
    out = fact.predict_batch(request)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = {f"rotate.{k}": c for k, c in k4.launches.items()}
    e_rel = float(np.max(np.abs(out["energy"] - dense["energy"]) / np.abs(dense["energy"])))
    f_abs = float(max(np.abs(a - b).max() for a, b in zip(out["forces"], dense["forces"])))
    print(f"factored flagship request ({N_STRUCTURES} structures, K4): {dt * 1e3:.1f} ms "
          f"(first call), against the dense run: energy max rel err {e_rel:.2e} (limit 1e-4), "
          f"forces max abs err {f_abs:.2e} (limit 1e-3); K4 launches {launches}  [{tag}]",
          flush=True)
    if not (e_rel <= 1e-4 and f_abs <= 1e-3):
        raise RuntimeError("the factored request disagrees with the dense one")
    idle = [n for n in ("rotate.to_m0", "rotate.from") if launches[n] == 0]
    if idle:
        raise RuntimeError(f"K4 kinds never launched on the factored request: {idle}")
    return launches


def oc20_phase(counters: dict, tag: str) -> tuple[dict, dict, dict]:
    """Phase 10: the OC20 step, factored (K4) and dense (K1) arms in turns,
    and 3 evaluation requests with the factored arm's EMA weights.  Returns
    the launches of the timed factored steps, of the timed dense steps and
    of the requests."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_oc20 import (
        predict,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        oc20_batch,
        oc20_train_state,
    )

    rng = np.random.default_rng(8)
    pbs = [oc20_batch(rng, OC20_GRAPHS, OC20_ATOMS)
           for _ in range(N_WARMUP_STEPS + N_TRAIN_STEPS + N_REQUESTS)]
    batches = [as_tensors(pb, "cuda") for pb in pbs]
    train, requests = batches[:-N_REQUESTS], batches[-N_REQUESTS:]
    arms = {rep: oc20_train_state(rep) for rep in ("factored", "dense")}
    n_params = sum(p.numel() for p in arms["factored"][0].model.parameters())
    print(f"OC20: full-width EquiformerV2OC20 (12 layers, 128 channels, lmax 6 / mmax 2, "
          f"8 heads, FFN 512, 600 RBF, cutoff 12, {n_params / 1e6:.2f} M parameters), bf16 "
          f"compute, f32 masters, dropouts 0, {OC20_GRAPHS} structures x {OC20_ATOMS} atoms, "
          f"N_pad {pbs[0].pos.shape[0]}, E_pad {pbs[0].edge_src.shape[0]} "
          f"({int(pbs[0].edge_mask.sum())} real edges), AdamW wd 1e-3, "
          f"warmup_cosine(4e-4, 100, 10000), EMA 0.999  [{tag}]", flush=True)

    def run(rep: str, i, batch):
        before = {n: d[k] for n, (d, k) in counters.items()}
        t = time.perf_counter()
        loss, m = arms[rep][1](batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        loss = float(loss)
        if not (np.isfinite(loss) and m["accepted"]):
            raise RuntimeError(f"OC20 step {i} ({rep}): loss {loss}, accepted {m['accepted']}")
        per = {n: d[k] - before[n] for n, (d, k) in counters.items() if d[k] != before[n]}
        print(f"OC20 step {i} {rep:8s}: {dt * 1e3:.1f} ms, {OC20_GRAPHS / dt:.2f} graphs/s, "
              f"loss {loss:.4f} (E-MSE {float(m['energy_mse']):.4f}, F-L1 "
              f"{float(m['force_l1']):.4f}), |g| {float(m['grad_norm']):.3f}, "
              f"launches {per}  [{tag}]", flush=True)
        return dt

    for rep in arms:
        for i in range(N_WARMUP_STEPS):
            run(rep, f"warm-up {i}", train[i])
    timed = train[N_WARMUP_STEPS:]
    times = {rep: [] for rep in arms}
    peak, launches = {}, {}
    for block, rep in enumerate(("factored", "dense", "dense", "factored")):   # A B B A
        if block < 2:
            torch.cuda.reset_peak_memory_stats()
            for d, k in counters.values():
                d[k] = 0
        times[rep] += [run(rep, i, b) for i, b in enumerate(timed)]
        if block < 2:
            launches[rep] = {n: d[k] for n, (d, k) in counters.items()}
            peak[rep] = torch.cuda.max_memory_allocated() / 2**30
    for rep in arms:
        med = float(np.median(times[rep]))
        print(f"OC20 training, wigner {rep:8s}: median step {med * 1e3:.1f} ms "
              f"({min(times[rep]) * 1e3:.1f}-{max(times[rep]) * 1e3:.1f} over {len(times[rep])} "
              f"steps in two blocks), {OC20_GRAPHS / med:.2f} graphs/s, peak memory "
              f"{peak[rep]:.3f} GiB, launches per step "
              f"{ {n: c / N_TRAIN_STEPS for n, c in launches[rep].items() if c} }  [{tag}]",
              flush=True)
    print(f"OC20 composed A/B: step factored (K4) / dense (K1) = "
          f"{np.median(times['factored']) / np.median(times['dense']):.3f}  [{tag}]", flush=True)
    need = ("rotate.to", "rotate.from", "s2act.k1", "s2act.k2")
    idle = [n for n in need if launches["factored"][n] == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on the OC20 training path: {idle}")

    state = arms["factored"][0]
    del arms["dense"]
    for d, k in counters.values():
        d[k] = 0
    for i, batch in enumerate(requests):
        t = time.perf_counter()
        out = predict(state.model, batch, state.ema)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        e, f = out["energy"], out["forces"]
        if (e.shape != (OC20_GRAPHS,) or f.shape != batch["pos"].shape
                or not (torch.isfinite(e).all() and torch.isfinite(f).all())):
            raise RuntimeError(f"OC20 request {i}: bad outputs {tuple(e.shape)} {tuple(f.shape)}")
        print(f"OC20 request {i}: {OC20_GRAPHS} structures, {dt * 1e3:.1f} ms, "
              f"{OC20_GRAPHS / dt:.2f} structures/s  [{tag}]", flush=True)
    eval_launches = {n: d[k] for n, (d, k) in counters.items()}
    print(f"launches over {N_REQUESTS} OC20 requests: "
          f"{ {n: c for n, c in eval_launches.items() if c} }  [{tag}]", flush=True)
    return launches["factored"], launches["dense"], eval_launches


def oc20_parity_phase(tag: str) -> None:
    """Phase 11: one f32 OC20 step (dropouts 0, factored), 2 layers at full
    width, 2 structures of 72 atoms, on the card and on the CPU plain path
    from the same weights: loss <= 1e-4 relative, gradients (after each
    device's own clip) <= 1e-3 relative L2."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs.oc20 import config
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_oc20 import (
        build_oc20_model,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
        make_oc20_train_step,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        oc20_batch,
    )

    cfg = dict(config, num_layers=2, alpha_drop=0.0, drop_path_rate=0.0)
    weights = init_weights(build_oc20_model(cfg), torch.Generator().manual_seed(9)).state_dict()
    pb = oc20_batch(np.random.default_rng(10), 2, OC20_ATOMS)
    res = {}
    for dev in ("cuda", "cpu"):
        model = build_oc20_model(cfg)
        model.load_state_dict(weights)
        model.to(dev)
        state = create_train_state(model, GuardedAdamW(model.named_parameters(),
                                                       lambda step: 4e-4, 1e-3, 1.0))
        loss, m = make_oc20_train_step(state)(as_tensors(pb, dev))
        res[dev] = dict(loss=float(loss), gnorm=float(m["grad_norm"]),
                        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    g, c = res["cuda"], res["cpu"]
    loss_rel = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    num = sum(float(((g["grads"][k].double() - c["grads"][k].double()) ** 2).sum())
              for k in c["grads"])
    den = sum(float((c["grads"][k].double() ** 2).sum()) for k in c["grads"])
    grad_rel = (num / den) ** 0.5
    print(f"OC20 gpu vs cpu plain path, one f32 training step (2 layers, full width, 2 x "
          f"{OC20_ATOMS} atoms, factored): loss {g['loss']:.6f} vs {c['loss']:.6f}, rel err "
          f"{loss_rel:.2e} (limit 1e-4); |g| {g['gnorm']:.4f} vs {c['gnorm']:.4f}, gradient "
          f"rel L2 err {grad_rel:.2e} (limit 1e-3)  [{tag}]", flush=True)
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-3):
        raise RuntimeError("the OC20 training step on the card disagrees with the CPU plain path")


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in want)
    den = sum(float((want[k].double() ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def baseline_phase(counters: dict, tag: str) -> dict:
    """Phase 12a: the ``baseline`` config (the original EquiformerV2, no
    GATA, per-graph stress at w_stress 0.1) at its full width, the
    flagship's: 2 + 5 bf16 training steps on the flagship's batches, the
    separable S2 activation on the edges (K2a / K2b / K2c at K = 19,
    P = 324 on [9920, 19, 128]) and K1 "to" / "from" in a grad-of-grad by
    positions and strain."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_matpes import (
        CONFIGS,
        build_model,
    )

    cfg = CONFIGS["baseline"]
    model = init_weights(build_model(cfg, True), torch.Generator().manual_seed(5)).to("cuda")
    _, step = _train_state(model, cfg["w_stress"])
    return _timed_steps(step, counters, f"baseline bf16 step with stress (w_stress "
                        f"{cfg['w_stress']}, {cfg['num_layers']} layers, alpha_drop "
                        f"{cfg['alpha_drop']}, drop_path {cfg['drop_path_rate']})", tag)


def baseline_parity_phase(tag: str) -> None:
    """Phase 12b: one f32 step of a 2-layer baseline model at the flagship
    widths with stress on 2 structures with stress labels, on the card and
    on the CPU plain path from the same weights: loss <= 1e-4 relative;
    gradients, forces and stress <= 1e-3 relative L2 (phase 7's limits)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    cfg = dict(FLAGSHIP, num_layers=2, gata=False, alpha_drop=0.0, drop_path_rate=0.0,
               **FIXED_DEGREE)
    weights = init_weights(EquiformerV2MatPES(**cfg), torch.Generator().manual_seed(6))
    weights = {k: v.clone() for k, v in weights.state_dict().items()}
    rng = np.random.default_rng(6)
    samples = labelled_structures(rng, 2, N_ATOMS)
    for smp in samples:
        smp.stress = (rng.normal(size=6) * 0.05).astype(np.float32)
    n_pad, e_pad = fixed_degree_pads([N_ATOMS] * 2, MAX_NEIGHBORS)
    pb = collate(samples, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, fixed_degree=True)
    res = {}
    for dev in ("cuda", "cpu"):
        model = EquiformerV2MatPES(**cfg)
        model.load_state_dict(weights)
        model.to(dev).train()
        batch = as_tensors(pb, dev)
        with full_f32_products():
            outs = matpes_energy_forces(model, batch, create_graph=True, regress_stress=True)
            loss, m = matpes_loss(outs, batch, 1.0, 1.0, 0.1)
            loss.backward()
        res[dev] = dict(loss=float(loss.detach()), stress_l1=float(m["stress_l1"].detach()),
                        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                        forces={"f": outs["forces"].detach().cpu()},
                        stress={"s": outs["stress"].detach().cpu()})
    g, c = res["cuda"], res["cpu"]
    errs = dict(loss=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
                gradients=_rel_l2(g["grads"], c["grads"]),
                forces=_rel_l2(g["forces"], c["forces"]),
                stress=_rel_l2(g["stress"], c["stress"]))
    print(f"baseline gpu vs cpu plain path, one f32 step with stress (2 layers, flagship "
          f"widths, 2 x {N_ATOMS} atoms): loss {g['loss']:.6f} vs {c['loss']:.6f}, stress_l1 "
          f"{g['stress_l1']:.6f} vs {c['stress_l1']:.6f}; rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (limits: loss 1e-4, the others 1e-3 relative L2)  [{tag}]", flush=True)
    if not (errs["loss"] <= 1e-4 and all(v <= 1e-3 for k, v in errs.items() if k != "loss")):
        raise RuntimeError("the baseline stress step on the card disagrees with the CPU")


def options_phase(tag: str) -> None:
    """Phase 12c: one full-width bf16 flagship step with each GATA-V2
    option of the JAX configs (``no-attn-norm``, ``phi-every-layer``):
    finite and accepted."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )

    (batch,) = _flagship_batches(1, seed=8)
    for option in (dict(normalize_attn_output=False), dict(use_phi_every_layer=True)):
        model = EquiformerV2MatPES(**FLAGSHIP, alpha_drop=0.0, drop_path_rate=0.0,
                                   compute_dtype=torch.bfloat16, **option, **FIXED_DEGREE)
        init_weights(model, torch.Generator().manual_seed(7)).to("cuda")
        _, step = _train_state(model)
        t = time.perf_counter()
        loss, m = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        print(f"flagship bf16 step with {option}: loss {float(loss):.4f}, accepted "
              f"{m['accepted']}, {dt * 1e3:.1f} ms (first step)  [{tag}]", flush=True)
        if not (np.isfinite(float(loss)) and m["accepted"]):
            raise RuntimeError(f"the flagship step with {option} failed")
        del model, step


def fixture_phase(tag: str) -> None:
    """Phase 12d: train the ``fixture`` config (MatPES-format fixture data)
    for 2 epochs on the card into a temporary directory, evaluate its
    checkpoint with train/test_matpes.py on the card and on the CPU, and
    serve its test structures through ``Predictor.from_checkpoint``.  The
    MAEs of the three must agree within phase 5's limits: energy 1e-4
    relative, forces 1e-3 eV/A (1 meV/A) absolute."""
    import shutil
    import tempfile

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.matpes import (
        load_matpes,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import (
        test_matpes,
        train_matpes,
    )

    data = {k: os.path.join(HERE, train_matpes.CONFIGS["fixture"][k])
            for k in ("data_path", "split_path")}
    run = tempfile.mkdtemp(prefix="matpes_fixture_")
    try:
        t = time.perf_counter()
        state = train_matpes.main(["--config", "fixture", "--epochs", "2"],
                                  overrides={"run_dir": run, **data})
        torch.cuda.synchronize()
        print(f"fixture: 2 epochs, {state.step} steps on the card in "
              f"{time.perf_counter() - t:.1f} s  [{tag}]", flush=True)
        ckpt = os.path.join(run, "ckpt_best")
        evals = {dev: test_matpes.main(["--checkpoint", ckpt, "--device", dev])
                 for dev in ("cuda", "cpu")}
        pred = Predictor.from_checkpoint(run, device="cuda")
        _, _, test, _ = load_matpes(data["data_path"], data["split_path"],
                                    normalize_energy=False)
        out = pred.predict_batch([dict(atomic_numbers=test[i].atomic_numbers,
                                       positions=test[i].pos, cell=test[i].cell)
                                  for i in range(len(test))])
        evals["Predictor (cuda)"] = {
            "energy_mae_mev_per_atom": 1e3 * float(np.mean(
                [abs(out["energy_per_atom"][i] - test[i].energy) for i in range(len(test))])),
            "force_mae_mev_per_a": 1e3 * float(np.mean(np.concatenate(
                [np.abs(out["forces"][i] - test[i].forces).ravel()
                 for i in range(len(test))])))}
    finally:
        shutil.rmtree(run, ignore_errors=True)
    ref = evals["cpu"]
    print("fixture test MAEs (energy meV/atom, force meV/A): " + "; ".join(
        f"{k} {v['energy_mae_mev_per_atom']:.4f} / {v['force_mae_mev_per_a']:.4f}"
        for k, v in evals.items()) + f"  [{tag}]", flush=True)
    for k, v in evals.items():
        de = abs(v["energy_mae_mev_per_atom"] - ref["energy_mae_mev_per_atom"])
        df = abs(v["force_mae_mev_per_a"] - ref["force_mae_mev_per_a"])
        if not (de <= 1e-4 * ref["energy_mae_mev_per_atom"] and df <= 1.0):
            raise RuntimeError(f"fixture evaluation {k} disagrees with the CPU: energy MAE "
                               f"{de:.3e} meV/atom, force MAE {df:.3e} meV/A apart")


HEADLINE = "equiformer_v2_matpes_gatav2_htr_global_distance"
PARITY_PRESETS = (HEADLINE, "equiformer_v2_matpes_gata", "equiformer_v2_matpes_gatav2_moe")


def _k1_kinds(model) -> tuple[tuple, tuple]:
    """The K1 kinds a preset's serving call and its force-training step
    launch: GATA (V2 or v1) rotates only the m = 0 block in, the others the
    whole message; the training step adds the adjoints."""
    bb = model.backbone
    if bb.gata or bb.gata_v1:
        return ("to_m0", "from"), ("to_m0", "from", "to", "from_m0")
    return ("to", "from"), ("to", "from")


def _preset_counters(lm: tuple[int, int]) -> dict:
    """K1's counters at the preset's (lmax, mmax), named as the records
    are, and K2's."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense,
        s2act,
    )

    sfx = "" if lm == (4, 2) else f"[{lm[0]},{lm[1]}]"
    return {**{f"rotate_pairs.{k}{sfx}": (rotate_dense.launches_by_lm, (k,) + lm)
               for k in rotate_dense.KINDS},
            **{f"s2act.{k}": (s2act.launches, k) for k in ("k1", "k2", "k3")}}


def _zero(counters: dict) -> None:
    for d, k in counters.values():
        d[k] = 0


def variants_phase(tag: str) -> dict:
    """Phase 13a: every MatPES preset of the port's registry at the
    flagship's widths (with the preset's own overrides: GATA v1 at mmax 4),
    dropout off, seeded random weights: one f32 serving request of 16 x 30
    atoms through ``Predictor`` and one bf16 force-training step (guarded
    AdamW + EMA) on a flagship batch, each with the launch counts zeroed
    just before.  Fails if an output or loss is not finite, the guard
    skipped the step, or K1 (at the preset's (lmax, mmax)) or K2 never
    launched where the path runs them."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.registry import (
        list_models,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        random_structures,
        variant_model,
    )

    request = random_structures(np.random.default_rng(0), N_STRUCTURES, N_ATOMS)
    (batch,) = _flagship_batches(1, seed=9)
    out = {}
    for name in [n for n in list_models() if "matpes" in n]:
        model = variant_model(name, seed=11)
        lm = (model.backbone.lmax, model.backbone.mmax)
        counters = _preset_counters(lm)
        serve_kinds, train_kinds = _k1_kinds(model)
        sfx = "" if lm == (4, 2) else f"[{lm[0]},{lm[1]}]"
        pred = Predictor(model, {k: v.clone() for k, v in model.state_dict().items()},
                         CUTOFF, MAX_NEIGHBORS, device="cuda")
        _zero(counters)
        t = time.perf_counter()
        res = pred.predict_batch(request)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t) * 1e3
        serve = {n: d[k] for n, (d, k) in counters.items()}
        ok = (res["energy"].shape == (N_STRUCTURES,) and np.isfinite(res["energy"]).all()
              and all(f.shape == (N_ATOMS, 3) and np.isfinite(f).all() for f in res["forces"]))
        del pred, model
        tmodel = variant_model(name, torch.bfloat16, seed=11, **FIXED_DEGREE).to("cuda")
        _, step = _train_state(tmodel)
        _zero(counters)
        t = time.perf_counter()
        loss, m = step(batch)
        torch.cuda.synchronize()
        train_ms = (time.perf_counter() - t) * 1e3
        train = {n: d[k] for n, (d, k) in counters.items()}
        print(f"preset {name} (lmax {lm[0]}, mmax {lm[1]}, "
              f"{sum(p.numel() for p in tmodel.parameters())} parameters): f32 request "
              f"{serve_ms:.1f} ms (first), launches {serve}; bf16 step {train_ms:.1f} ms "
              f"(first), loss {float(loss):.4f}, accepted {m['accepted']}, launches {train}  "
              f"[{tag}]", flush=True)
        idle = ([f"serving {k}" for k in [f"rotate_pairs.{k}{sfx}" for k in serve_kinds]
                 + ["s2act.k1"] if serve[k] == 0]
                + [f"training {k}" for k in [f"rotate_pairs.{k}{sfx}" for k in train_kinds]
                   + ["s2act.k1", "s2act.k2", "s2act.k3"] if train[k] == 0])
        if not ok or not (np.isfinite(float(loss)) and m["accepted"]) or idle:
            raise RuntimeError(f"preset {name}: outputs finite {ok}, loss {float(loss)}, "
                               f"accepted {m['accepted']}, kernels never launched {idle}")
        out[name] = dict(serving=serve, training=train, serving_ms=serve_ms,
                         training_ms=train_ms)
        del tmodel, step
        torch.cuda.empty_cache()
    return out


def headline_phase(tag: str) -> dict:
    """Phase 13b: the headline preset (GATA-V2, phi every layer, global HTR
    attention with the RoPE bias) at the flagship's widths on the flagship's
    batches: 3 serving requests (latency, structures/s), then 2 + 7 timed
    bf16 training steps (median ms, graphs/s, launches per step, peak
    memory), then one profiled step (utils/profiling.py --variant)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import profiling

    model = profiling.variant_model(HEADLINE, seed=12)
    counters = _preset_counters((4, 2))
    pred = Predictor(model, {k: v.clone() for k, v in model.state_dict().items()},
                     CUTOFF, MAX_NEIGHBORS, device="cuda")
    rng = np.random.default_rng(0)
    requests = [profiling.random_structures(rng, N_STRUCTURES, N_ATOMS)
                for _ in range(N_REQUESTS)]
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    for i, req in enumerate(requests):
        before = {n: d[k] for n, (d, k) in counters.items()}
        t = time.perf_counter()
        res = pred.predict_batch(req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if not (np.isfinite(res["energy"]).all()
                and all(np.isfinite(f).all() for f in res["forces"])):
            raise RuntimeError(f"{HEADLINE} request {i}: outputs not finite")
        per = {n: d[k] - before[n] for n, (d, k) in counters.items()}
        print(f"{HEADLINE} request {i}: {N_STRUCTURES} structures, {dt * 1e3:.1f} ms, "
              f"{N_STRUCTURES / dt:.1f} structures/s, launches {per}  [{tag}]", flush=True)
    print(f"{HEADLINE} serving peak memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  "
          f"[{tag}]", flush=True)
    del pred, model
    tmodel = profiling.variant_model(HEADLINE, torch.bfloat16, seed=12, **FIXED_DEGREE).to("cuda")
    _, step = _train_state(tmodel)
    launches = _timed_steps(step, {n: c for n, c in counters.items()},
                            f"{HEADLINE} bf16 step", tag, n_timed=7)
    del tmodel, step
    torch.cuda.empty_cache()
    recs = profiling.run(["--variant", HEADLINE])
    return dict(launches=launches, profile=recs)


def variant_parity_phase(tag: str) -> None:
    """Phase 13c: one f32 force-training loss and its gradients of the
    headline preset, GATA v1 (K1 at (4, 4)) and the MoE, at the flagship's
    widths with the depth cut to 2 layers, on 2 labelled structures, on the
    card and on the CPU plain path from the same weights: loss <= 1e-4
    relative, gradients and forces <= 1e-3 relative L2 (phase 7's limits)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import (
        as_tensors,
        collate,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        variant_model,
    )

    samples = labelled_structures(np.random.default_rng(13), 2, N_ATOMS)
    n_pad, e_pad = fixed_degree_pads([N_ATOMS] * 2, MAX_NEIGHBORS)
    pb = collate(samples, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad, fixed_degree=True)
    for name in PARITY_PRESETS:
        weights = {k: v.clone() for k, v in
                   variant_model(name, seed=13, num_layers=2, **FIXED_DEGREE).state_dict().items()}
        res = {}
        for dev in ("cuda", "cpu"):
            model = variant_model(name, seed=13, num_layers=2, **FIXED_DEGREE)
            model.load_state_dict(weights)
            model.to(dev).train()
            batch = as_tensors(pb, dev)
            with full_f32_products():
                outs = matpes_energy_forces(model, batch, create_graph=True)
                loss, _ = matpes_loss(outs, batch, 1.0, 1.0)
                loss.backward()
            res[dev] = dict(loss=float(loss.detach()), forces={"f": outs["forces"].detach().cpu()},
                            grads={n: (torch.zeros_like(p) if p.grad is None else p.grad)
                                   .detach().cpu() for n, p in model.named_parameters()})
            del model
        g, c = res["cuda"], res["cpu"]
        errs = dict(loss=abs(g["loss"] - c["loss"]) / abs(c["loss"]),
                    gradients=_rel_l2(g["grads"], c["grads"]),
                    forces=_rel_l2(g["forces"], c["forces"]))
        print(f"{name} gpu vs cpu plain path, one f32 force-training step (2 layers, flagship "
              f"widths, 2 x {N_ATOMS} atoms): loss {g['loss']:.6f} vs {c['loss']:.6f}; rel err "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (limits: loss 1e-4, the others 1e-3 relative L2)  [{tag}]", flush=True)
        if not (errs["loss"] <= 1e-4 and errs["gradients"] <= 1e-3 and errs["forces"] <= 1e-3):
            raise RuntimeError(f"the {name} step on the card disagrees with the CPU")


# phases 17-19: the ragged serving path, the other layouts and Wigner
# representation in training, and the bf16 step's determinism
LAYOUT_STEP_NEED = ["s2act.k1", "s2act.k2", "s2act.k3"]


def _samples(structs: list[dict]) -> list:
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import GraphSample

    return [GraphSample(atomic_numbers=s["atomic_numbers"], pos=s["positions"],
                        cell=s.get("cell"), pbc=s.get("cell") is not None) for s in structs]


def _mixed_request(seed: int = 17) -> list[dict]:
    """The mixed-size request (``utils/profiling.py:MIXED``)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        mixed_structures,
    )

    return mixed_structures(np.random.default_rng(seed))


def _collated_request(model, pb, device: str = "cuda"):
    """A callable serving the padded batch ``pb`` of either layout on
    ``device`` as ``Predictor.predict_batch`` does after its collate: the
    copy to the device, the energies and forces, and each structure's
    energy and forces back on the host (no energy normalisation)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        energy_and_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    natoms = np.asarray(pb.natoms)
    rows = np.flatnonzero(pb.node_mask)
    offs = np.concatenate([[0], np.cumsum(natoms)])

    def serve():
        with full_f32_products():
            outs = energy_and_forces(model, as_tensors(pb, device))
        forces = outs["forces"].cpu().numpy()
        return {"energy": outs["energy"][:, 0].cpu().numpy() * natoms,
                "forces": [forces[rows[a:b]] for a, b in zip(offs[:-1], offs[1:])]}

    return serve


def _host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn()`` over ``reps`` calls."""
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms))


def _request_record(serve, counters: dict) -> dict:
    """CUDA-event ms of one request (median of 10 after 2 warm-ups), the
    peak device memory over them and one request's kernel launches."""
    for _ in range(2):
        serve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(10):
        if i == 0:
            _zero(counters)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = serve()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        if i == 0:
            launches = {n: d[k] for n, (d, k) in counters.items()}
    return dict(ms=float(np.median(ms)), ms_min=min(ms), ms_max=max(ms),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches, out=out)


def _agree(got: dict, want: dict, natoms, what: str, tag: str) -> None:
    """Phase 5's limit values on a request of mixed sizes: each structure's
    energy error per atom within 1e-4 of the request's largest per-atom
    |E| (a random-weight structure's energy can lie near zero, where the
    relative error of phase 5 is float32 noise over a small number; it is
    printed beside), forces 1e-3 absolute (max |F| printed beside)."""
    natoms = np.asarray(natoms)
    d_e = np.abs(got["energy"] - want["energy"]) / natoms
    scale = float((np.abs(want["energy"]) / natoms).max())
    e_err = float(d_e.max() / scale)
    rel = np.abs(got["energy"] - want["energy"]) / np.abs(want["energy"])
    worst = int(np.argmax(rel))
    f_abs = float(max(np.abs(a - b).max() for a, b in zip(got["forces"], want["forces"])))
    f_max = float(max(np.abs(b).max() for b in want["forces"]))
    print(f"  {what}: energy per atom max abs err {d_e.max():.2e} = {e_err:.2e} of the "
          f"largest per-atom |E| {scale:.4f} (limit 1e-4; per-structure max rel err "
          f"{rel[worst]:.2e} at |E| {abs(want['energy'][worst]):.3f}, {natoms[worst]} atoms), "
          f"forces max abs err {f_abs:.2e} (limit 1e-3; max |F| {f_max:.1f})  [{tag}]",
          flush=True)
    if not (e_err <= 1e-4 and f_abs <= 1e-3):
        raise RuntimeError(f"{what}: the results disagree")


def check_ragged_kernels(pb, tag: str) -> list[dict]:
    """Phase 17, the kernels at the ragged serving request's shapes: K1's
    four kinds on the request's edges (E any multiple of 128: a partial
    last tile) and K2a / K2b on its nodes (N a multiple of 16), each
    against its plain version (phase 3's limits)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP as cfg,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense as rd,
    )

    dev = torch.device("cuda")
    lmax, mmax, C = cfg["lmax"], cfg["mmax"], cfg["sphere_channels"]
    dvec = edge_vectors(as_tensors(pb, "cuda"))
    E = dvec.shape[0]
    K, Kr = (lmax + 1) ** 2, rd._pair_info(lmax, mmax)["n_out"]["to"]
    hv = cfg["num_heads"] * cfg["attn_value_channels"]
    gen = torch.Generator(device=dev).manual_seed(17)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    w = rd.compute_wigner_dense(lmax, mmax, dvec)
    site = f"ragged mixed-size request (E {E})"
    specs = [("to_m0", (E, K, 2 * C), (w.v_to_m0, w.v_from_m0)),
             ("from", (E, Kr, hv), (w.v_from_res, w.v_to_res)),
             ("to", (E, K, hv), (w.v_to_res, w.v_from_res)),
             ("from_m0", (E, lmax + 1, 2 * C), (w.v_from_m0, w.v_to_m0))]
    records = []
    for kind, shape, (v, va) in specs:
        name = f"rotate_pairs.{kind}[ragged]"
        records.append(_k1_record(name, [_k1_site(kind, shape, v, va, site, lmax, mmax, True,
                                                  gen, flush, tag, False, name)]))
    del w
    N = int(pb.pos.shape[0])
    records += check_k2(N, tag, sites=[(f"ragged request FFN (N {N})", (lmax, lmax, 18), N,
                                        cfg["ffn_hidden_channels"], "[ragged]", False)])
    return records


def _trace_line(t: dict) -> str:
    buckets = ", ".join(f"{k} {v:.2f}" for k, v in list(t["buckets_ms"].items())[:4])
    return (f"kernels {t['kernel_ms']:.2f} ms in {t['kernel_launches']} launches, device busy "
            f"{t['device_busy_share'] * 100:.1f} % of the profiled call; by bucket: {buckets}")


def ragged_serving_phase(state: dict, requests: list, tag: str) -> list[dict]:
    """Phase 17: the ragged ``Predictor`` (the serving path) on the
    mixed-size request (``utils/profiling.py:MIXED``) and the flagship
    request of 16 x 30 atoms at full width, each against the same request
    on the CPU and against the same weights served in the fixed-degree
    layout (the port's serving batch before it), within phase 5's limit
    values (``_agree``).  Both layouts are timed over the same work: the
    device call on a batch collated before the clock starts (CUDA events,
    median of 10 after 2 warm-ups), with each layout's host collate timed
    apart and the Predictor's whole call beside; one device call of each
    is profiled (torch.profiler).  N_pad, E_pad, peak memory and K1 / K2
    launches of both.  The 16 x 30 request is also served fixed-degree on
    the CPU (printed, not a gate): whether the card's force gap to the CPU
    comes from the card or from the ragged sums.  Then the kernels at the
    ragged request's shapes.  Returns the kernels' rows, with the launches
    of one ragged mixed-size request."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import collate
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense,
        s2act,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        profile_call,
    )

    def fixed_model(device: str):
        m = EquiformerV2MatPES(**FLAGSHIP, **FIXED_DEGREE)
        m.load_state_dict(state)
        return m.to(device).eval()

    counters = {**{f"rotate_pairs.{k}": (rotate_dense.launches, k)
                   for k in rotate_dense.launches},
                **{f"s2act.{k}": (s2act.launches, k) for k in ("k1", "k2")}}
    cases = {"mixed-size": _mixed_request(), "16 x 30": requests[0]}
    summary, ragged_launches, mixed_pb = {}, None, None
    for what, structs in cases.items():
        natoms = [len(s["atomic_numbers"]) for s in structs]
        pred = Predictor(EquiformerV2MatPES(**FLAGSHIP), state, CUTOFF, MAX_NEIGHBORS,
                         device="cuda")
        pb = pred.collate(structs)
        got = pred.predict_batch(structs)
        serve = _collated_request(pred.model, pb)
        rec = _request_record(serve, counters)
        rec["host_ms"] = _host_ms(lambda: pred.collate(structs))
        rec["predictor_ms"] = _request_record(lambda: pred.predict_batch(structs), counters)["ms"]
        rec["trace"] = profile_call(serve)
        del pred, serve
        torch.cuda.empty_cache()
        cpu = Predictor(EquiformerV2MatPES(**FLAGSHIP), state, CUTOFF, MAX_NEIGHBORS,
                        device="cpu").predict_batch(structs)

        def fixed_collate():
            return collate(_samples(structs), CUTOFF, MAX_NEIGHBORS,
                           *fixed_degree_pads(natoms, MAX_NEIGHBORS), fixed_degree=True)

        fpb = fixed_collate()
        serve = _collated_request(fixed_model("cuda"), fpb)
        frec = _request_record(serve, counters)
        frec["host_ms"] = _host_ms(fixed_collate)
        frec["trace"] = profile_call(serve)
        del serve
        torch.cuda.empty_cache()
        for lay, p, r in (("ragged", pb, rec), ("fixed-degree", fpb, frec)):
            t = r["trace"]
            summary[f"{what} {lay}"] = dict(
                n_pad=int(p.pos.shape[0]), e_pad=int(p.edge_src.shape[0]),
                real_edges=int(p.edge_mask.sum()), ms=r["ms"], ms_min=r["ms_min"],
                ms_max=r["ms_max"], host_collate_ms=r["host_ms"],
                predictor_ms=r.get("predictor_ms"), peak_gib=r["peak_gib"],
                launches=r["launches"], kernel_ms=t["kernel_ms"],
                kernel_launches=t["kernel_launches"], busy_share=t["device_busy_share"],
                buckets_ms=t["buckets_ms"])
            whole = (f"; Predictor.predict_batch, collate included, {r['predictor_ms']:.2f} ms"
                     if lay == "ragged" else "")
            print(f"serving {what} request ({len(structs)} structures, {sum(natoms)} atoms), "
                  f"{lay} layout: N_pad {p.pos.shape[0]}, E_pad {p.edge_src.shape[0]} "
                  f"({int(p.edge_mask.sum())} real edges), {r['ms']:.2f} ms per request on the "
                  f"collated batch (CUDA events, median of 10 after 2 warm-ups; "
                  f"{r['ms_min']:.2f}-{r['ms_max']:.2f}), host collate {r['host_ms']:.2f} ms "
                  f"(median of 5){whole}, peak {r['peak_gib']:.3f} GiB, launches per request "
                  f"{r['launches']}  [{tag}]", flush=True)
            print(f"  profiled {what} {lay} call: {_trace_line(t)}  [{tag}]", flush=True)
        _agree(got, cpu, natoms, f"{what} ragged, card against the CPU", tag)
        _agree(frec["out"], rec["out"], natoms,
               f"{what} fixed-degree against ragged, on the card", tag)
        if what == "16 x 30":
            fcpu = _collated_request(fixed_model("cpu"), fpb, "cpu")()
            f_abs = max(float(np.abs(a - b).max()) for a, b in zip(frec["out"]["forces"],
                                                                    fcpu["forces"]))
            summary[f"{what} fixed-degree"]["card_vs_cpu_forces_max_abs"] = f_abs
            print(f"  {what} fixed-degree, card against the CPU (a record): forces max abs err "
                  f"{f_abs:.2e}  [{tag}]", flush=True)
        idle = [n for n, c in rec["launches"].items() if c == 0]
        if idle:
            raise RuntimeError(f"kernels never launched on the ragged {what} request: {idle}")
        if what == "mixed-size":
            ragged_launches, mixed_pb = rec["launches"], pb
    print(f"ragged serving: {json.dumps(summary)}  [{tag}]", flush=True)
    rows = check_ragged_kernels(mixed_pb, tag)
    for r in rows:
        base = r["name"].split("[")[0]
        r["launches"] = ragged_launches[base]
        r["launches_per_ragged_mixed_request"] = ragged_launches[base]
    return rows


def layout_step_phase(tag: str) -> None:
    """Phase 18: one full-width flagship bf16 force-training step in the
    graph-uniform layout (phase 6's structures collated with
    ``uniform=True``, per-graph slots as ``infer_pad_sizes`` sizes them)
    and one on the ``blocks`` Wigner representation (the fixed-degree
    batch): finite, accepted, K2a-c launched, and K1's four kinds in the
    uniform step (the blocks representation rotates by batched matmuls)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense,
        s2act,
    )

    counters = {**{f"rotate_pairs.{k}": (rotate_dense.launches, k)
                   for k in rotate_dense.launches},
                **{f"s2act.{k}": (s2act.launches, k) for k in s2act.launches}}
    (uniform,) = _flagship_batches(1, seed=18, layout="uniform")
    (fixed,) = _flagship_batches(1, seed=18)
    cases = [("uniform blocks", dict(uniform_blocks=True), uniform),
             ("blocks Wigner", dict(wigner_rep="blocks", **FIXED_DEGREE), fixed)]
    for what, kw, batch in cases:
        model = EquiformerV2MatPES(**FLAGSHIP, alpha_drop=0.0, drop_path_rate=0.0,
                                   compute_dtype=torch.bfloat16, **kw)
        init_weights(model, torch.Generator().manual_seed(18)).to("cuda")
        _, step = _train_state(model)
        step(batch)
        torch.cuda.synchronize()
        _zero(counters)
        t = time.perf_counter()
        loss, m = step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {n: d[k] for n, (d, k) in counters.items()}
        print(f"layout step, {what} (bf16, full width, N_pad {batch['pos'].shape[0]}, E_pad "
              f"{batch['edge_src'].shape[0]}): second step {ms:.1f} ms, loss {float(loss):.4f}, "
              f"|g| {float(m['grad_norm']):.3f}, accepted {m['accepted']}, launches "
              f"{launches}  [{tag}]", flush=True)
        need = LAYOUT_STEP_NEED + ([] if "wigner_rep" in kw else
                                   [f"rotate_pairs.{k}" for k in rotate_dense.launches])
        idle = [n for n in need if launches[n] == 0]
        if not (np.isfinite(float(loss)) and m["accepted"]) or idle:
            raise RuntimeError(f"layout step {what}: loss {float(loss)}, accepted "
                               f"{m['accepted']}, kernels never launched {idle}")
        del model, step
        torch.cuda.empty_cache()


def determinism_phase(tag: str) -> dict:
    """Phase 19: the gradient half of the flagship bf16 step twice from one
    state on one batch (phase 6's model and layout): the two gradient sets
    must be bit for bit equal (ops/segment.py's deterministic gather and
    sum carry the step's reductions by ids).  Then the host syncs of one
    gradient half (``torch.cuda.set_sync_debug_mode``) and the whole step
    (guarded AdamW and EMA) timed: CUDA events, median of 10 after 2
    warm-ups, and the peak device memory over them."""
    import warnings

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        make_matpes_train_step,
        matpes_loss_grad,
    )

    state = _flagship_state(torch.bfloat16)
    (batch,) = _flagship_batches(1, seed=19)
    loss_grad = matpes_loss_grad(state)
    runs = []
    for _ in range(3):   # the first call warms up
        loss, _ = loss_grad(batch)
        runs.append((float(loss), {n: p.grad.detach().clone()
                                   for n, p in state.model.named_parameters()
                                   if p.grad is not None}))
    (la, ga), (lb, gb) = runs[1:]
    same = sum(bool(torch.equal(ga[n], gb[n])) for n in ga)
    spread = _rel_l2(ga, gb)
    print(f"determinism: two bf16 flagship loss gradients from one state: losses {la!r} / "
          f"{lb!r}, gradients rel L2 {spread:.3e}, {same} of {len(ga)} parameters bit for bit "
          f"equal  [{tag}]", flush=True)
    if la != lb or same != len(ga):
        raise RuntimeError("the bf16 step differs from itself")
    del runs, ga, gb
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        loss_grad(batch)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode(0)
    # the mode's own first warning (a prototype that "does not yet detect all
    # synchronizing operations") is no sync
    syncs = sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)
    step = make_matpes_train_step(state)
    batches = [batch] + _flagship_batches(1, seed=20)
    for b in batches:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _, m = step(batches[i % 2])
        b.record()
        b.synchronize()
        if not m["accepted"]:
            raise RuntimeError(f"deterministic bf16 step {i} was not accepted")
        ms.append(a.elapsed_time(b))
    rec = dict(spread=spread, params=same, host_syncs=syncs, step_ms=float(np.median(ms)),
               step_ms_min=min(ms), step_ms_max=max(ms),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    print(f"determinism: host syncs in one loss gradient {syncs}; bf16 flagship step "
          f"(N_pad 496, E_pad 9920) {rec['step_ms']:.2f} ms (CUDA events, median of 10 after 2 "
          f"warm-ups; {rec['step_ms_min']:.2f}-{rec['step_ms_max']:.2f}), peak "
          f"{rec['peak_gib']:.3f} GiB  [{tag}]", flush=True)
    return rec


# phase 20: rematerialization of the flagship force-training step
REMAT_SIZES = (16, 64)    # structures of N_ATOMS atoms a batch
# mode -> (the model's remat, the step's inner_ckpt)
REMAT_MODES = {"off": (False, False), "remat": (True, False), "inner_ckpt": (False, True),
               "remat + inner_ckpt": (True, True)}
REMAT_F32_LIMIT = 1e-5    # the f32 16 x 30 step's gradients against remat off (rel L2)


def _grad_half(state, batch, inner: bool) -> tuple[float, dict]:
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss_grad,
    )

    loss, _ = matpes_loss_grad(state, inner_ckpt=inner)(batch)
    return float(loss), {n: p.grad.detach().clone()
                         for n, p in state.model.named_parameters() if p.grad is not None}


def _differing(got: dict, want: dict) -> list[str]:
    """The parameters whose gradients are not bit for bit equal."""
    return [n for n, g in want.items() if not torch.equal(got[n], g)]


def _event_ms(fn, reps: int) -> list[float]:
    ms = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return ms


def _force_pass_ms(state, batch) -> dict:
    """CUDA-event ms (median of 5 after 1 warm-up) of the remat'd bf16 force
    pass (forces with their graph kept, no loss backward) with the bf16
    parameter copies requiring a gradient (the step's: each block's
    backward also computes its parameters' VJP) and with them detached (no
    parameter VJP)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        cast_params,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    model = state.model
    out = {}
    for what, detach in (("with parameter VJPs", False), ("without", True)):
        def call():
            with full_f32_products():
                params = cast_params(model, torch.bfloat16)
                if detach:
                    params = {n: p.detach() for n, p in params.items()}
                matpes_energy_forces(model, batch, create_graph=True, params=params)
        call()
        out[what] = float(np.median(_event_ms(call, 5)))
    return out


def remat_phase(counters: dict, tag: str) -> dict:
    """Phase 20: the flagship bf16 force-training step (phase 6's model,
    layout and structures) at 16 x 30 and 64 x 30 atoms in each mode of
    ``REMAT_MODES``: from one state and batch, each mode's gradient half
    (after warm-up calls: a process's first two calls differ) against
    remat off (loss and gradients within ``DP_LIMITS[bf16]``,
    and whether bit for bit equal); the off and remat halves twice (at
    16 x 30 the remat half must repeat bit for bit, as phase 19's step);
    then each mode's step timed with
    CUDA events (median of 5 after 2 warm-ups), the peak device memory over
    the timed steps and K1 / K2a-c launches per step (every kernel of the
    path must launch).  At 64 x 30 remat's peak must be at most 0.6x the
    peak without.  Then the f32 step at 16 x 30: remat and inner_ckpt
    gradients within ``REMAT_F32_LIMIT`` of remat off; and the remat'd
    bf16 force pass with and without the parameters' VJPs.  Returns the
    records."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        make_matpes_train_step,
    )

    lim_loss, lim_grad = DP_LIMITS[torch.bfloat16]
    recs = {}
    for structures in REMAT_SIZES:
        batches = _flagship_batches(1 + N_WARMUP_STEPS + N_TRAIN_STEPS, seed=20,
                                    structures=structures)
        state = _flagship_state(torch.bfloat16)
        size = f"{structures} x {N_ATOMS}"
        print(f"remat: flagship bf16 step, {size} atoms, N_pad {batches[0]['pos'].shape[0]}, "
              f"E_pad {batches[0]['edge_src'].shape[0]}  [{tag}]", flush=True)
        ref = None
        # a process's first two gradient halves differ from the later ones
        # in bf16 (8.4e-4 relative L2, with or without remat; phase 19 warms
        # up too): warm up twice, then once more in each mode
        _grad_half(state, batches[0], False)
        for mode, (use_remat, inner) in REMAT_MODES.items():   # from one state: no update
            state.model.backbone.remat = use_remat
            _grad_half(state, batches[0], inner)
            loss, grads = _grad_half(state, batches[0], inner)
            if ref is None:
                ref = (loss, grads)
            rec = recs[(size, mode)] = dict(
                loss_rel=abs(loss / ref[0] - 1), grad_rel_l2=_rel_l2(grads, ref[1]),
                differ_off=_differing(grads, ref[1]))
            rec["bit_equal_off"] = loss == ref[0] and not rec["differ_off"]
            if mode in ("off", "remat"):
                again = _grad_half(state, batches[0], inner)
                rec["differ_repeat"] = _differing(again[1], grads)
                rec["repeat_bit_equal"] = again[0] == loss and not rec["differ_repeat"]
                rec["repeat_rel_l2"] = _rel_l2(again[1], grads)
            del grads
        del ref
        for mode, (use_remat, inner) in REMAT_MODES.items():
            state.model.backbone.remat = use_remat
            rec = recs[(size, mode)]
            step = make_matpes_train_step(state, inner_ckpt=inner)
            for b in batches[1:1 + N_WARMUP_STEPS]:
                step(b)
            torch.cuda.synchronize()
            _zero(counters)
            torch.cuda.reset_peak_memory_stats()
            timed = iter(batches[1 + N_WARMUP_STEPS:])
            accepted = []
            ms = _event_ms(lambda: accepted.append(bool(step(next(timed))[1]["accepted"])),
                           N_TRAIN_STEPS)
            rec.update(step_ms=float(np.median(ms)), step_ms_min=min(ms), step_ms_max=max(ms),
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                       launches={n: d[k] / N_TRAIN_STEPS for n, (d, k) in counters.items()})
            print(f"remat {size} {mode}: loss rel {rec['loss_rel']:.3e}, gradients rel L2 "
                  f"{rec['grad_rel_l2']:.3e} against off (limits {lim_loss:.1e}, "
                  f"{lim_grad:.1e}; bit for bit {rec['bit_equal_off']}, parameters differing "
                  f"{rec['differ_off'][:4]} of {len(rec['differ_off'])})"
                  + (f", repeat bit for bit {rec['repeat_bit_equal']} (rel L2 "
                     f"{rec['repeat_rel_l2']:.3e}; parameters differing "
                     f"{rec['differ_repeat'][:4]} of {len(rec['differ_repeat'])})"
                     if "repeat_bit_equal" in rec else "")
                  + f"; step {rec['step_ms']:.2f} ms (CUDA events, median of {N_TRAIN_STEPS} "
                  f"after {N_WARMUP_STEPS} warm-ups; {rec['step_ms_min']:.2f}-"
                  f"{rec['step_ms_max']:.2f}), peak {rec['peak_gib']:.3f} GiB, launches per "
                  f"step {rec['launches']}  [{tag}]", flush=True)
            idle = [n for n, c in rec["launches"].items() if c == 0]
            if not all(accepted) or idle:
                raise RuntimeError(f"phase 20 {size} {mode}: accepted {accepted}, kernels "
                                   f"never launched {idle}")
            if rec["loss_rel"] > lim_loss or rec["grad_rel_l2"] > lim_grad:
                raise RuntimeError(f"phase 20 {size} {mode}: the step disagrees with remat off")
            # phase 19's check, at phase 19's size (at 64 x 30 the step
            # without remat may differ from itself too: a bf16 bit of an
            # embedding gradient, 3e-9 relative L2, PERF.md section 6, PR 17)
            if (mode == "remat" and structures == REMAT_SIZES[0]
                    and not rec["repeat_bit_equal"]):
                raise RuntimeError(f"phase 20 {size}: the remat gradient half differs from "
                                   "itself")
        off, on = recs[(size, "off")], recs[(size, "remat")]
        print(f"remat {size}: peak remat / off {on['peak_gib'] / off['peak_gib']:.3f}, "
              f"remat + inner_ckpt / off "
              f"{recs[(size, 'remat + inner_ckpt')]['peak_gib'] / off['peak_gib']:.3f}, "
              f"inner_ckpt / off {recs[(size, 'inner_ckpt')]['peak_gib'] / off['peak_gib']:.3f}"
              f"; step remat / off {on['step_ms'] / off['step_ms']:.3f}  [{tag}]", flush=True)
        if structures == REMAT_SIZES[0]:
            state.model.backbone.remat = True
            fp = _force_pass_ms(state, batches[0])
            recs[(size, "force pass")] = fp
            print(f"remat {size}: the remat'd bf16 force pass {fp}, parameter VJPs "
                  f"{fp['with parameter VJPs'] - fp['without']:.2f} ms (CUDA events, median "
                  f"of 5)  [{tag}]", flush=True)
        if structures == REMAT_SIZES[-1] and on["peak_gib"] > 0.6 * off["peak_gib"]:
            raise RuntimeError(f"phase 20 {size}: remat's peak {on['peak_gib']:.3f} GiB is "
                               f"above 0.6x the peak without ({off['peak_gib']:.3f} GiB)")
        del state, batches
        torch.cuda.empty_cache()

    state = _flagship_state(torch.float32)
    (batch,) = _flagship_batches(1, seed=21)
    _grad_half(state, batch, False)
    loss0, g0 = _grad_half(state, batch, False)
    for mode in ("remat", "inner_ckpt"):
        state.model.backbone.remat = mode == "remat"
        loss, g = _grad_half(state, batch, mode == "inner_ckpt")
        err = _rel_l2(g, g0)
        recs[("16 x 30 f32", mode)] = dict(loss_rel=abs(loss / loss0 - 1), grad_rel_l2=err)
        print(f"remat 16 x 30 f32 {mode}: loss rel {abs(loss / loss0 - 1):.3e}, gradients rel "
              f"L2 {err:.3e} against off (limit {REMAT_F32_LIMIT:.0e})  [{tag}]", flush=True)
        if err > REMAT_F32_LIMIT or abs(loss / loss0 - 1) > REMAT_F32_LIMIT:
            raise RuntimeError(f"phase 20 f32 {mode}: the step disagrees with remat off")
    del state, g0, g
    torch.cuda.empty_cache()
    return recs


# phase 14: multi-process data-parallel training on the one card
DP_SEED = 14          # the micro-batches of phase 14 (_flagship_batches' seed)
DP_TIMEOUT_S = 600    # each group of spawned processes
# (loss and metrics relative, energies, forces and gradients relative L2)
# a data-parallel, composite or pipelined step is held to: phase 7's limits
# in float32; in bfloat16 4x the largest that phases 14-16 read with the
# deterministic segment sums (ops/segment.py; a bf16 step gives the same
# bits every run), all at the composite step's model=2 bf16 case: loss
# 3.24e-5 and force_l1 3.33e-5, forces 4.81e-4 (the ranks' partial sums
# take another order); the data-parallel and pipelined bf16 steps read 0
DP_LIMITS = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (1.3e-4, 1.9e-3)}
DP_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flagship_state(dtype: torch.dtype):
    """A fresh flagship TrainState computing in ``dtype`` on the card, from
    phase 6's seed (dropouts 0)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )

    model = EquiformerV2MatPES(**FLAGSHIP, alpha_drop=0.0, drop_path_rate=0.0,
                               compute_dtype=dtype, **FIXED_DEGREE)
    init_weights(model, torch.Generator().manual_seed(0)).to("cuda")
    return _train_state(model)[0]


def _digest(state) -> str:
    """sha256 of every parameter and EMA entry, in order."""
    import hashlib

    params = [p.detach() for p in state.model.parameters()] + list(state.ema.values())
    flat = torch.cat([t.reshape(-1) for t in params]).cpu()
    return hashlib.sha256(flat.numpy().tobytes()).hexdigest()


def _dp_rank(rank: int, port: int, out_dir: str) -> None:
    """Phase 14 (c) and (e) in a spawned process: rank ``rank`` of 2 on the
    one card over gloo (both ranks on cuda:0).  (c) in f32 and in bf16, 2
    flagship DP steps each, rank r on micro-batch 2 s + r of step s; (e)
    one full-width bf16 OC20 DP step.  Writes ``rank<r>.pt``: per precision
    the step-1 loss and (rank 0) averaged gradients and the parameter + EMA
    digests after each step; the launches; the OC20 step's."""
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), ETQ_DIST_BACKEND="gloo", LOCAL_RANK="0")
    import torch.distributed as dist

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs.oc20 import config
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate,
        rotate_dense,
        s2act,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import multihost
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel.data_parallel import (
        make_matpes_dp_step,
        make_oc20_dp_step,
        stack_microbatches,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        oc20_batch,
        oc20_train_state,
    )

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))   # the host's cores, shared
    if not multihost.initialize_from_env(device="cuda", verbose=False):
        raise RuntimeError("no process group")
    try:
        out = {"backend": dist.get_backend()}
        batches = _flagship_batches(4, seed=DP_SEED)
        counters = {**{f"rotate_pairs.{k}": (rotate_dense.launches, k)
                       for k in rotate_dense.launches},
                    **{f"s2act.{k}": (s2act.launches, k) for k in s2act.launches}}
        for d, k in counters.values():
            d[k] = 0
        for name, dtype in DP_DTYPES.items():
            state = _flagship_state(dtype)
            step = make_matpes_dp_step(state, 2)
            res = out[name] = {"digests": [], "ms": []}
            for s in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, m = step(stack_microbatches([batches[2 * s + rank]]))
                torch.cuda.synchronize()
                res["ms"].append((time.perf_counter() - t) * 1e3)
                if not (np.isfinite(float(loss)) and m["accepted"]):
                    raise RuntimeError(f"rank {rank} {name} step {s}: loss {float(loss)}, "
                                       f"accepted {m['accepted']}")
                res["digests"].append(_digest(state))
                if s == 0:
                    res["loss"] = float(loss)
                    if rank == 0:
                        res["grads"] = {n: g.to("cpu", copy=True)
                                        for n, g in step.mean_grads().items()}
            del state, step
        out["launches"] = {n: d[k] for n, (d, k) in counters.items()}
        del batches

        ostate, _ = oc20_train_state("factored")
        ostep = make_oc20_dp_step(ostate, 2, config["w_energy"], config["w_force"],
                                  config["ema_decay"])
        pb = oc20_batch(np.random.default_rng(20 + rank), OC20_GRAPHS, OC20_ATOMS)
        for k in rotate.launches:
            rotate.launches[k] = 0
        t = time.perf_counter()
        loss, m = ostep(stack_microbatches([as_tensors(pb, "cuda")]))
        torch.cuda.synchronize()
        out["oc20"] = dict(loss=float(loss), accepted=bool(m["accepted"]),
                           ms=(time.perf_counter() - t) * 1e3, digest=_digest(ostate),
                           launches=dict(rotate.launches))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(target, nprocs: int, *args, timeout: float = DP_TIMEOUT_S) -> None:
    """Run ``target(rank, *args)`` in ``nprocs`` spawned processes; raise
    unless every one exits 0 within ``timeout`` s (a hung one is killed)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
        codes.append(p.exitcode)
    if codes != [0] * nprocs:
        raise RuntimeError(f"{target.__name__}: exit codes {codes}")


def _dp_check(what: str, dtype, loss: float, want_loss: float, grads: dict, want: dict,
              tag: str) -> tuple[float, float]:
    """Hold a data-parallel step's loss and gradients to ``DP_LIMITS``."""
    lim_loss, lim_grad = DP_LIMITS[dtype]
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    grad_rel = _rel_l2(grads, want)
    print(f"{what}: loss {loss:.6f} vs {want_loss:.6f}, rel err {loss_rel:.2e} (limit "
          f"{lim_loss:.0e}); gradient rel L2 err {grad_rel:.2e} (limit {lim_grad:.0e})  [{tag}]",
          flush=True)
    if not (loss_rel <= lim_loss and grad_rel <= lim_grad):
        raise RuntimeError(f"{what}: the data-parallel step disagrees")
    return loss_rel, grad_rel


def dp_phase(counters: dict, tag: str) -> dict:
    """Phase 14: data-parallel training (parallel/data_parallel.py) on the
    one card.  Returns the launches of (a)'s bf16 step, counted from zero."""
    import tempfile

    import torch.distributed as dist

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.synthetic import (
        labelled_structures,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel.data_parallel import (
        make_matpes_dp_step,
        stack_microbatches,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        matpes_loss_grad,
    )

    def single(dtype, batch):
        state = _flagship_state(dtype)
        loss, _ = matpes_loss_grad(state)(batch)
        return float(loss), {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                             for n, p in state.model.named_parameters()}

    out = {"a": {}, "b": {}, "c": {}}
    batches = _flagship_batches(2, seed=DP_SEED)
    stacked = stack_microbatches(batches)
    print(f"data-parallel: the flagship step, data=2 micro-batches of {N_STRUCTURES} x "
          f"{N_ATOMS} atoms, in f32 and in bf16  [{tag}]", flush=True)

    # (a) one process, data=2, against the mean of the two single steps
    want, launches = {}, {}
    for name, dtype in DP_DTYPES.items():
        (l0, g0), (l1, g1) = single(dtype, batches[0]), single(dtype, batches[1])
        l0_again, g0_again = single(dtype, batches[0])
        print(f"(a) {name}: two runs of one single step differ by loss {abs(l0 - l0_again) / abs(l0):.2e}, "
              f"gradients {_rel_l2(g0_again, g0):.2e} relative L2 (the card's run-to-run "
              f"noise)  [{tag}]", flush=True)
        mean = {k: (g0[k] + g1[k]) / 2 for k in g0}
        norms = [sum(float((g[k].double() ** 2).sum()) for k in g) ** 0.5 for g in (g0, g1, mean)]
        print(f"(a) {name}: gradient norms |g0| {norms[0]:.4e}, |g1| {norms[1]:.4e}, their mean "
              f"{norms[2]:.4e} (the smaller the mean, the larger the same noise reads relative "
              f"to it)  [{tag}]", flush=True)
        del g0, g1, g0_again
        state = _flagship_state(dtype)
        step = make_matpes_dp_step(state, 2)
        for d, k in counters.values():
            d[k] = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, m = step(stacked)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        launches[name] = {n: d[k] for n, (d, k) in counters.items()}
        if not (np.isfinite(float(loss)) and m["accepted"]):
            raise RuntimeError(f"(a) {name}: loss {float(loss)}, accepted {m['accepted']}")
        want[name] = (float(loss), {k: v.clone() for k, v in step.mean_grads().items()})
        print(f"(a) {name} one process, data=2: {dt * 1e3:.1f} ms, launches "
              f"{launches[name]}  [{tag}]", flush=True)
        out["a"][name] = _dp_check(f"(a) {name} against the mean of the two single steps",
                                   dtype, float(loss), (l0 + l1) / 2, want[name][1], mean, tag)
        idle = [n for n, c in launches[name].items() if c == 0]
        if idle:
            raise RuntimeError(f"kernels never launched on the data-parallel path: {idle}")
        del state, step, mean

    # (b) the same steps inside a one-rank NCCL group
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        for name, dtype in DP_DTYPES.items():
            state = _flagship_state(dtype)
            step = make_matpes_dp_step(state, 2)
            flat = step.accumulate(stacked)
            local = flat.clone()
            step.reduce(flat)
            same = torch.equal(flat, local / 2)
            buf = local.clone()
            for _ in range(3):
                dist.all_reduce(buf)
            ts = []
            for _ in range(15):
                a, b = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                a.record()
                dist.all_reduce(buf)
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            loss, m = step.finish(flat)
            print(f"(b) {name} NCCL, world size 1: all-reduce of the flat buffer, "
                  f"{buf.numel() * 4} bytes ({buf.numel()} f32), median {np.median(ts):.4f} ms "
                  f"over 15; after it and the division, bit-identical to the local mean: "
                  f"{same}  [{tag}]", flush=True)
            if not same:
                raise RuntimeError("(b): the one-rank all-reduce changed the gradients")
            out["b"][name] = dict(allreduce_ms=float(np.median(ts)), bytes=buf.numel() * 4,
                                  errors=_dp_check(f"(b) {name} against (a)", dtype,
                                                   float(loss), want[name][0],
                                                   step.mean_grads(), want[name][1], tag))
            del state, step, flat, local, buf
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        # (c) + (e): two ranks on the one card over gloo
        t = time.perf_counter()
        _spawn(_dp_rank, 2, _free_port(), tmp)
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        print(f"(c) 2 ranks over gloo on one card (gloo copies CUDA tensors through the "
              f"host: these times are no data-parallel speed): the spawned group took "
              f"{time.perf_counter() - t:.1f} s; step ms f32 {ranks[0]['f32']['ms']} / "
              f"{ranks[1]['f32']['ms']}, bf16 {ranks[0]['bf16']['ms']} / "
              f"{ranks[1]['bf16']['ms']}; launches rank 0 {ranks[0]['launches']}, rank 1 "
              f"{ranks[1]['launches']}; peak {ranks[0]['peak_gib']:.2f} / "
              f"{ranks[1]['peak_gib']:.2f} GiB  [{tag}]", flush=True)
        if any(r["backend"] != "gloo" for r in ranks):
            raise RuntimeError(f"(c): backends {[r['backend'] for r in ranks]}")
        for r in ranks:
            idle = [n for n, c in r["launches"].items() if c == 0]
            if idle:
                raise RuntimeError(f"(c): kernels never launched in a rank: {idle}")
        for name, dtype in DP_DTYPES.items():
            d0, d1 = ranks[0][name]["digests"], ranks[1][name]["digests"]
            if d0 != d1:
                raise RuntimeError(f"(c) {name}: the ranks' parameters differ: {d0} / {d1}")
            print(f"(c) {name}: parameters and EMA bit-identical on both ranks after steps 1 "
                  f"and 2 (sha256 {d0[0][:16]}..., {d0[1][:16]}...)  [{tag}]", flush=True)
            grads = {k: v.cuda() for k, v in ranks[0][name]["grads"].items()}
            out["c"][name] = _dp_check(f"(c) {name} 2 ranks against (a)", dtype,
                                       ranks[0][name]["loss"], want[name][0], grads,
                                       want[name][1], tag)
            del grads
        o = [r["oc20"] for r in ranks]
        print(f"(e) OC20 full-width bf16 DP step, 2 ranks over gloo: loss {o[0]['loss']:.4f} / "
              f"{o[1]['loss']:.4f}, {o[0]['ms']:.1f} / {o[1]['ms']:.1f} ms, launches "
              f"{o[0]['launches']} / {o[1]['launches']}, replicas identical "
              f"{o[0]['digest'] == o[1]['digest']}  [{tag}]", flush=True)
        for r in o:
            if not (np.isfinite(r["loss"]) and r["accepted"] and r["launches"]["to"]
                    and r["launches"]["from"]):
                raise RuntimeError(f"(e): {r}")
        if o[0]["digest"] != o[1]["digest"] or o[0]["loss"] != o[1]["loss"]:
            raise RuntimeError("(e): the OC20 ranks differ")
        del want

        # (d) the CLI: two processes over gloo, rank 0 writes, rank 1 writes nothing
        port = _free_port()
        procs = []
        for r in range(2):
            cwd = os.path.join(tmp, f"cli{r}")
            os.makedirs(cwd)
            env = dict(os.environ, WORLD_SIZE="2", RANK=str(r), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), ETQ_DIST_BACKEND="gloo", LOCAL_RANK="0",
                       OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)),
                       PYTHONPATH=os.pathsep.join([HERE, os.environ.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{PKG}.train.train_matpes", "--config", "synthetic",
                 "--multihost", "--mesh", "data=2", "--epochs", "1"], cwd=cwd, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        t = time.perf_counter()
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=DP_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        run0 = os.path.join(tmp, "cli0", "runs", "matpes_synthetic")
        wrote = sorted(os.listdir(run0)) if os.path.isdir(run0) else []
        rank1 = sorted(os.listdir(os.path.join(tmp, "cli1")))
        print(f"(d) train_matpes --config synthetic --multihost --mesh data=2 --epochs 1, 2 "
              f"processes over gloo: rc {[p.returncode for p in procs]}, "
              f"{time.perf_counter() - t:.1f} s; rank 0 wrote {wrote}; rank 1 wrote "
              f"{rank1 or 'nothing'}  [{tag}]", flush=True)
        print("\n".join("  rank 0: " + line for line in logs[0].strip().splitlines()[-4:]))
        need = {"losses.csv", "metrics.json", "config.json", "ckpt_best.pt",
                "ckpt_epoch_00000.pt"}
        if [p.returncode for p in procs] != [0, 0] or not need <= set(wrote) or rank1:
            raise RuntimeError("(d): the data-parallel CLI failed:\n" + "\n".join(
                f"--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs)))

    # (f) the host graph build + collate of the flagship batch: C++ builder and numpy
    samples = labelled_structures(np.random.default_rng(2), N_STRUCTURES, N_ATOMS)
    n_pad, e_pad = fixed_degree_pads([N_ATOMS] * N_STRUCTURES, MAX_NEIGHBORS)
    ms, pbs = {}, {}
    try:
        for native in (True, False, False, True):
            graph.USE_NATIVE = native
            ts = []
            for _ in range(7):
                t = time.perf_counter()
                pbs[native] = graph.collate(samples, CUTOFF, MAX_NEIGHBORS, n_pad, e_pad,
                                            fixed_degree=True)
                ts.append((time.perf_counter() - t) * 1e3)
            ms.setdefault(native, []).extend(ts)
    finally:
        graph.USE_NATIVE = True
    same = all(np.array_equal(pbs[True].asdict()[k], pbs[False].asdict()[k])
               for k in ("edge_src", "edge_dst", "edge_shift", "edge_mask"))
    n_edges = int(pbs[True].edge_mask.sum())
    out["f"] = {"native_ms": float(np.median(ms[True])), "numpy_ms": float(np.median(ms[False]))}
    print(f"(f) host graph build + collate of the flagship batch ({N_STRUCTURES} x {N_ATOMS} "
          f"atoms, {n_edges} edges), median of 14: C++ builder {out['f']['native_ms']:.2f} ms, "
          f"numpy {out['f']['numpy_ms']:.2f} ms "
          f"({out['f']['numpy_ms'] / out['f']['native_ms']:.1f}x); edges identical: {same}  "
          f"[{tag}]", flush=True)
    if not same:
        raise RuntimeError("(f): the C++ neighbour list differs from numpy's")
    print(f"data-parallel phase: {json.dumps(out)}  [{tag}]", flush=True)
    return launches["bf16"]

# phase 15: composite DP x TP x EP x SP training on the one card
TP_SEED = 15          # the micro-batches of phase 15 (_flagship_batches' seed)
TP_LR = 2e-4          # a constant rate (phase 7's): the first step moves every master
TP_TIMEOUT_S = 900    # each group of spawned processes
# (case, (data, model), sp, dtype, layers (None: the flagship's 6), model,
# edge layout)
TP_CASES = [
    ("a f32", (1, 2), False, "f32", None, "flagship", "fixed"),
    ("a bf16", (1, 2), False, "bf16", None, "flagship", "fixed"),
    ("b f32 sp", (1, 2), True, "f32", None, "flagship", "fixed"),
    ("b bf16 sp", (1, 2), True, "bf16", None, "flagship", "fixed"),
    ("c MoE EP", (1, 2), False, "f32", 2, "equiformer_v2_matpes_gatav2_moe", "fixed"),
    ("e conv_fused", (1, 2), False, "f32", 2, "conv_fused", "fixed"),
    ("f f32 sp ragged", (1, 2), True, "f32", None, "flagship", "ragged"),
    ("f bf16 sp ragged", (1, 2), True, "bf16", None, "flagship", "ragged"),
    ("g bf16 sp uniform", (1, 2), True, "bf16", None, "flagship", "uniform"),
    ("d data=2 model=2", (2, 2), False, "f32", 2, "flagship", "fixed"),
]
# the models' layout fields of each batch layout
TP_LAYOUTS = {"fixed": FIXED_DEGREE, "ragged": {}, "uniform": dict(uniform_blocks=True)}
# the sharded shapes' kernel rows (K1 at the rank's heads or edges, K2 at
# the rank's FFN channels) and the case whose rank-0 step counts their launches
TP_K2_SITES = [("flagship FFN, model=2", (4, 4, 18), None, 256, "[tp]", True)]
TP_ROW_CASE = {"[tp]": "a bf16", "[sp]": "b bf16 sp", "[sp ragged]": "f bf16 sp ragged"}


def _tp_state(spec):
    """A fresh TrainState of a phase-15 case on the card: seeded random
    weights (the same in every process), dropouts 0, guarded AdamW at the
    constant ``TP_LR``."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        GuardedAdamW,
        create_train_state,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        variant_model,
    )

    _, _, _, dt, layers, what, layout = spec
    kw = dict(TP_LAYOUTS[layout]) if layers is None else {"num_layers": layers,
                                                           **TP_LAYOUTS[layout]}
    if what.startswith("equiformer"):
        model = variant_model(what, DP_DTYPES[dt], seed=0, **kw)
    else:
        model = EquiformerV2MatPES(**{**FLAGSHIP, **kw}, alpha_drop=0.0, drop_path_rate=0.0,
                                   compute_dtype=DP_DTYPES[dt],
                                   conv_fused=what == "conv_fused")
        init_weights(model, torch.Generator().manual_seed(0))
    model.to("cuda")
    opt = GuardedAdamW(model.named_parameters(), lambda step: TP_LR, 1e-3, 1.0)
    return create_train_state(model, opt)


def _tp_counters() -> dict:
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense,
        s2act,
        so2conv,
    )

    return {**{f"rotate_pairs.{k}": (rotate_dense.launches, k) for k in rotate_dense.launches},
            **{f"s2act.{k}": (s2act.launches, k) for k in s2act.launches},
            **{f"so2conv.{k}": (so2conv.launches, k) for k in so2conv.launches}}


def _tp_run(spec, mesh, batches: list[dict]) -> dict:
    """One phase-15 case on this process's ranks of ``mesh``: the energies
    and forces of data row 0's first micro-batch, then one composite step
    (``parallel/sharding.py``) with the launch counts zeroed just before;
    the step's loss and metrics and the gathered gradients, masters and EMA
    (on the host), the launches, ms, collectives and the rank's edge shard
    (edges, node rows)."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import sharding
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel.data_parallel import (
        rank_seed,
        stack_microbatches,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    name, (data, _), sp = spec[:3]
    state = _tp_state(spec)
    gen = torch.Generator("cuda").manual_seed(rank_seed(TP_SEED, mesh.data_index))
    step = sharding.make_composite_matpes_step(state, mesh, data, sp=sp, generator=gen)
    local, shard = sharding.batch_shards(stack_microbatches(batches[:data]), mesh, sp)
    with full_f32_products():
        outs = matpes_energy_forces(state.model, {k: v[0] for k, v in local.items()})
    counters = _tp_counters()
    for d, k in counters.values():
        d[k] = 0
    for k in mesh.mp.counts:
        mesh.mp.counts[k] = mesh.mp.bytes[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, m = step(local)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {n: d[k] for n, (d, k) in counters.items()}
    if not (np.isfinite(float(loss)) and m["accepted"]):
        raise RuntimeError(f"phase 15 {name}: loss {float(loss)}, accepted {m['accepted']}")
    model = state.model

    def host(named):
        return {k: v.detach().to("cpu", copy=True)
                for k, v in sharding.gather_named(named, model, mesh).items()}

    return dict(loss=float(loss), metrics={k: float(m[k]) for k in ("energy_l1", "force_l1")},
                energy=outs["energy"].detach().cpu(), forces=outs["forces"].detach().cpu(),
                grads=host(step.mean_grads()),
                params=host({k: p for k, p in model.named_parameters()}),
                ema=host(state.ema), launches=launches, ms=ms,
                collectives={k: (mesh.mp.counts[k], mesh.mp.bytes[k]) for k in mesh.mp.counts},
                edge_shard=None if shard is None else [
                    (shard.edges.start, shard.edges.stop), (shard.rows.start, shard.rows.stop)],
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _tp_rank(rank: int, world: int, port: int, out_dir: str, names: list[str]) -> None:
    """Phase 15 in a spawned process: rank ``rank`` of ``world`` on the one
    card over gloo; every case of ``names``; rank 0 writes each case's
    results, every rank its launches, ms and collectives."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), ETQ_DIST_BACKEND="gloo", LOCAL_RANK="0")
    import torch.distributed as dist

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import (
        multihost,
        sharding,
    )

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    if not multihost.initialize_from_env(device="cuda", verbose=False):
        raise RuntimeError("no process group")
    try:
        batches = {}
        for spec in (s for s in TP_CASES if s[0] in names):
            name, (_, M), sp, layout = spec[0], spec[1], spec[2], spec[6]
            if layout not in batches:
                batches[layout] = _flagship_batches(2, seed=TP_SEED, layout=layout)
            res = _tp_run(spec, sharding.make_composite_mesh(M), batches[layout])
            keep = res if rank == 0 else {k: res[k] for k in
                                          ("loss", "launches", "ms", "collectives",
                                           "edge_shard", "peak_gib")}
            torch.save(keep, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
            del res, keep
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _split_facts(batch: dict, size: int) -> tuple[int, int]:
    """(the nodes whose real incoming edges lie on more than one of ``size``
    ranks' even slices of the edge axis, the padded edges on the last
    rank's)."""
    E = batch["edge_dst"].shape[0]
    rank = torch.arange(E, device=batch["edge_dst"].device) // (E // size)
    real = batch["edge_mask"]
    dst, r = batch["edge_dst"][real], rank[real]
    first = torch.full((batch["pos"].shape[0],), size, device=dst.device).scatter_reduce(
        0, dst, r, "amin")
    last = torch.full_like(first, -1).scatter_reduce(0, dst, r, "amax")
    return int(((last >= 0) & (last != first)).sum()), int((~real[rank == size - 1]).sum())


def check_sharded_kernels(batch, ragged, tag: str) -> list[dict]:
    """Phase 15, the kernels at the sharded shapes of model = 2, against
    their plain versions within phase 3's limits (f32 and bf16; forward,
    gradient and grad-of-grad through the autograd pairs): K1 "from" and its
    adjoint "to" on the rank's 4 heads ([E, 19, 64], [E, 25, 64]) and, under
    ``sp``, "to_m0", "from" and "from_m0" on the rank's E / 2 edges at every
    channel; K1's four kinds on the last rank's half of the ragged batch
    ``ragged`` (its padded edges included; E_pad / 2 is no multiple of the
    fixed-degree layout's 20 slots); K2a / K2b / K2c on the rank's 256 FFN
    channels, [496, 25, 256]."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP as cfg,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        rotate_dense as rd,
    )

    dev = torch.device("cuda")
    lmax, mmax, C = cfg["lmax"], cfg["mmax"], cfg["sphere_channels"]
    dvec = edge_vectors(batch)
    E = dvec.shape[0]
    K, Kr = (lmax + 1) ** 2, rd._pair_info(lmax, mmax)["n_out"]["to"]
    hv = cfg["num_heads"] * cfg["attn_value_channels"]
    gen = torch.Generator(device=dev).manual_seed(15)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    w = rd.compute_wigner_dense(lmax, mmax, dvec)
    wh = rd.compute_wigner_dense(lmax, mmax, dvec[: E // 2])
    rvec = edge_vectors(ragged)
    Er = rvec.shape[0] // 2
    wr = rd.compute_wigner_dense(lmax, mmax, rvec[Er:])
    specs = [
        ("from", "[tp]", (E, Kr, hv // 2), (w.v_from_res, w.v_to_res),
         "model=2 attention back, 4 heads"),
        ("to", "[tp]", (E, K, hv // 2), (w.v_to_res, w.v_from_res),
         "model=2, adjoint of from"),
        ("to_m0", "[sp]", (E // 2, K, 2 * C), (wh.v_to_m0, wh.v_from_m0),
         "sp attention in, m=0, E/2"),
        ("from", "[sp]", (E // 2, Kr, hv), (wh.v_from_res, wh.v_to_res),
         "sp attention back, E/2"),
        ("from_m0", "[sp]", (E // 2, lmax + 1, 2 * C), (wh.v_from_m0, wh.v_to_m0),
         "sp, adjoint of to_m0, E/2"),
        ("to_m0", "[sp ragged]", (Er, K, 2 * C), (wr.v_to_m0, wr.v_from_m0),
         "sp ragged attention in, m=0, last rank's E_pad/2"),
        ("from", "[sp ragged]", (Er, Kr, hv), (wr.v_from_res, wr.v_to_res),
         "sp ragged attention back, E_pad/2"),
        ("to", "[sp ragged]", (Er, K, hv), (wr.v_to_res, wr.v_from_res),
         "sp ragged, adjoint of from, E_pad/2"),
        ("from_m0", "[sp ragged]", (Er, lmax + 1, 2 * C), (wr.v_from_m0, wr.v_to_m0),
         "sp ragged, adjoint of to_m0, E_pad/2"),
    ]
    records = []
    for kind, sfx, shape, (v, va), site in specs:
        name = f"rotate_pairs.{kind}{sfx}"
        records.append(_k1_record(name, [_k1_site(kind, shape, v, va, site, lmax, mmax, True,
                                                  gen, flush, tag, False, name)]))
    del w, wh, wr
    return records + check_k2(int(batch["pos"].shape[0]), tag, TP_K2_SITES)


def tp_phase(batch, tag: str) -> list[dict]:
    """Phase 15: the composite DP x TP x EP x SP step (parallel/sharding.py)
    on the one card, its ranks spawned over gloo (NCCL places one rank per
    GPU); returns the kernel rows at the sharded shapes, their launches
    those of rank 0's step in ``TP_ROW_CASE``."""
    import tempfile

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import sharding
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        apply_updates,
    )

    batches = {layout: _flagship_batches(2, seed=TP_SEED, layout=layout)
               for layout in TP_LAYOUTS}
    records = check_sharded_kernels(batch, batches["ragged"][0], tag)
    print(f"composite step: {len(TP_CASES)} cases at (data, model) ranks on the one card "
          f"over gloo (gloo copies CUDA tensors through the host; the ranks share one card: "
          f"no times below are a tensor-parallel speed)  [{tag}]", flush=True)
    for layout, (b, _) in batches.items():
        straddling, padded = _split_facts(b, 2)
        print(f"composite step, {layout} batches: N_pad {b['pos'].shape[0]}, E_pad "
              f"{b['edge_src'].shape[0]}; at model=2 {straddling} nodes have real edges on "
              f"both ranks, the last rank holds {padded} padded edges  [{tag}]", flush=True)
    refs = {}
    for spec in TP_CASES:   # the one-process step of each case
        refs[spec[0]] = _tp_run(spec, sharding.make_composite_mesh(1), batches[spec[6]])
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()
    mb = {}   # each case's collective MB per rank and step
    with tempfile.TemporaryDirectory() as tmp:
        for world in (2, 4):
            names = [s[0] for s in TP_CASES if s[1][0] * s[1][1] == world]
            t = time.perf_counter()
            _spawn(_tp_rank, world, world, _free_port(), tmp, names, timeout=TP_TIMEOUT_S)
            print(f"composite step: {world} ranks, cases {names}: the spawned group took "
                  f"{time.perf_counter() - t:.1f} s  [{tag}]", flush=True)
        for spec in TP_CASES:
            name, (data, M), sp, dt = spec[:4]
            ranks = [torch.load(os.path.join(tmp, f"{name}.rank{r}.pt"), weights_only=False)
                     for r in range(data * M)]
            got, want = ranks[0], refs[name]
            lim_loss, lim_grad = DP_LIMITS[DP_DTYPES[dt]]
            errs = dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                        **{k: abs(got["metrics"][k] - want["metrics"][k])
                           / abs(want["metrics"][k]) for k in want["metrics"]},
                        energy=_rel_l2({"e": got["energy"]}, {"e": want["energy"]}),
                        forces=_rel_l2({"f": got["forces"]}, {"f": want["forces"]}),
                        grads=_rel_l2(got["grads"], want["grads"]))
            # the update on identical gradients (phase 7): the one-process
            # optimizer and EMA from the ranks' gathered gradients
            replay = _tp_state(spec)
            start = {n: p.detach().cpu() for n, p in replay.model.named_parameters()}
            for n, p in replay.model.named_parameters():
                p.grad = got["grads"][n].to("cuda")
            apply_updates(replay)
            dp_ = max(float((got["params"][n] - p.detach().cpu()).abs().max())
                      for n, p in replay.model.named_parameters())
            de_ = max(float((got["ema"][n] - e.cpu()).abs().max())
                      for n, e in replay.ema.items())
            # the step's update beside the one-process step's (no limit: Adam's
            # first update is sign-like where |g| is near eps)
            moved = _rel_l2({n: got["params"][n] - start[n] for n in start},
                            {n: want["params"][n] - start[n] for n in start})
            del replay, start
            counts = [r["launches"] for r in ranks]
            mb[name] = [sum(b for _, b in r["collectives"].values()) / 1e6 for r in ranks]
            fixed_sp = f"b {dt} sp"
            beside = (f" (fixed-degree sp, {fixed_sp}: {[round(v, 1) for v in mb[fixed_sp]]})"
                      if sp and name != fixed_sp and fixed_sp in mb else "")
            print(f"composite ({name}): data={data} model={M} sp={sp} layout {spec[6]}, "
                  f"rank edge shard (edges, node rows) {[r['edge_shard'] for r in ranks]}; "
                  f"collective MB a step by rank {[round(v, 1) for v in mb[name]]}{beside}, "
                  f"(count, bytes) by rank {[r['collectives'] for r in ranks]}; "
                  f"loss {got['loss']:.6f} vs one process "
                  f"{want['loss']:.6f}; rel errs {', '.join(f'{k} {v:.2e}' for k, v in errs.items())} "
                  f"(limits loss and metrics {lim_loss:.0e}, energies, forces and gradients "
                  f"{lim_grad:.0e} relative L2); on the ranks' gradients, after the step: "
                  f"masters max |diff| {dp_:.2e}, EMA {de_:.2e} (limit {1e-2 * TP_LR:.1e} = "
                  f"1e-2 lr); the update against the one-process step's, rel L2 {moved:.2e}; "
                  f"step ms by rank {[round(r['ms'], 1) for r in ranks]} (one process "
                  f"{want['ms']:.1f}); peak GiB by rank "
                  f"{[round(r['peak_gib'], 2) for r in ranks]}; launches by rank {counts}  "
                  f"[{tag}]", flush=True)
            if not (max(errs[k] for k in ("loss", "energy_l1", "force_l1")) <= lim_loss
                    and max(errs[k] for k in ("energy", "forces", "grads")) <= lim_grad
                    and dp_ <= 1e-2 * TP_LR and de_ <= 1e-2 * TP_LR):
                raise RuntimeError(f"phase 15 {name}: the composite step disagrees with "
                                   "the one-process step")
            if any(r["loss"] != got["loss"] for r in ranks):
                raise RuntimeError(f"phase 15 {name}: the ranks' losses differ")
            need = ["rotate_pairs.to", "rotate_pairs.from", "rotate_pairs.to_m0",
                    "rotate_pairs.from_m0", "s2act.k1", "s2act.k2", "s2act.k3"]
            need += ["so2conv.fwd", "so2conv.adj"] if spec[5] == "conv_fused" else []
            idle = [(i, k) for i, c in enumerate(counts) for k in need if c[k] == 0]
            if idle:
                raise RuntimeError(f"phase 15 {name}: kernels never launched (rank, kernel): "
                                   f"{idle}")
        for r in records:
            sfx = r["name"][r["name"].index("["):]
            r["launches"] = torch.load(
                os.path.join(tmp, f"{TP_ROW_CASE[sfx]}.rank0.pt"),
                weights_only=False)["launches"][r["name"][: -len(sfx)]]
    return records


# phase 16: DP x GPipe pipeline training on the one card
PP_SEED = 16          # the micro-batches of phase 16 (_flagship_batches' seed)
PP_TIMEOUT_S = 900    # each group of spawned processes
# (case, (data, pipe), dtype): the flagship at its 6 layers, one micro-batch
# per data row (the CLI's n_micro = data)
PP_CASES = [
    ("a f32", (1, 2), "f32"),
    ("a bf16", (1, 2), "bf16"),
    ("b f32 pipe=3", (1, 3), "f32"),
    ("c bf16 data=2", (2, 2), "bf16"),
]
PP_NEED = ["rotate_pairs.to", "rotate_pairs.from", "rotate_pairs.to_m0",
           "rotate_pairs.from_m0", "s2act.k1", "s2act.k2", "s2act.k3"]


def _pp_spec(dt: str) -> tuple:
    """The phase-15 spec of the flagship at full width in ``dt`` (``_tp_state``)."""
    return ("flagship", (1, 1), False, dt, None, "flagship", "fixed")


def _pp_reference(spec, batches: list[dict]) -> dict:
    """The one-process step of a phase-16 case: ``data`` micro-batches in
    one process (``make_matpes_dp_step``, bfloat16 copies of the masters in
    bf16, as the pipeline step), the energies and forces of the first."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        matpes_energy_forces,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel.data_parallel import (
        make_matpes_dp_step,
        stack_microbatches,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    name, (data, _), dt = spec
    state = _tp_state(_pp_spec(dt))
    step = make_matpes_dp_step(state, data)
    with full_f32_products():
        outs = matpes_energy_forces(state.model, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, m = step(stack_microbatches(batches[:data]))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    if not (np.isfinite(float(loss)) and m["accepted"]):
        raise RuntimeError(f"phase 16 {name}: one-process loss {float(loss)}, "
                           f"accepted {m['accepted']}")
    return dict(loss=float(loss), metrics={k: float(m[k]) for k in ("energy_l1", "force_l1")},
                energy=outs["energy"].detach().cpu(), forces=outs["forces"].detach().cpu(),
                grads={k: v.to("cpu", copy=True) for k, v in step.mean_grads().items()},
                ms=ms, peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _pp_run(spec, batches: list[dict]) -> dict:
    """One phase-16 case on this process's rank: the energies and forces of
    its data row's micro-batch through the pipeline, then one pipeline step
    (``parallel/pipeline.py``) with the launch counts and the stage group's
    tallies zeroed just before; the step's loss and metrics, the whole
    gradients, masters and EMA (on the host, gathered over the stages), the
    launches, ms, peak memory, the ring shift's bytes and the ticks."""
    import torch.distributed as dist

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import pipeline
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel.data_parallel import (
        rank_seed,
        stack_microbatches,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.precision import (
        full_f32_products,
    )

    name, (data, pipe), dt = spec
    state = _tp_state(_pp_spec(dt))
    mesh = pipeline.make_dp_pipe_mesh(data, pipe)
    gen = torch.Generator("cuda").manual_seed(rank_seed(PP_SEED, dist.get_rank()))
    step = pipeline.make_pipeline_matpes_step(state, mesh, data, generator=gen)
    local = stack_microbatches(batches[mesh.data_index:mesh.data_index + 1])
    with full_f32_products():
        outs = pipeline.pipeline_energy_forces(state.model, [batches[mesh.data_index]], mesh)[0]
    counters = _tp_counters()
    for d, k in counters.values():
        d[k] = 0
    g = mesh.stages
    for k in g.counts:
        g.counts[k] = g.bytes[k] = 0
    g.ticks = g.bubble = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    loss, m = step(local)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {n: d[k] for n, (d, k) in counters.items()}
    if not (np.isfinite(float(loss)) and m["accepted"]):
        raise RuntimeError(f"phase 16 {name}: loss {float(loss)}, accepted {m['accepted']}")
    parts = [None] * pipe
    dist.all_gather_object(parts, {k: v.to("cpu", copy=True)
                                   for k, v in step.mean_grads().items()}, group=g.group)
    sd = state.state_dict()
    return dict(loss=float(loss), metrics={k: float(m[k]) for k in ("energy_l1", "force_l1")},
                energy=outs["energy"].detach().cpu(), forces=outs["forces"].detach().cpu(),
                grads={k: v for part in parts for k, v in part.items()},
                params=sd["model"], ema=sd["ema"], launches=launches, ms=ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                stage=[mesh.stage.start, mesh.stage.stop], tick_bytes=g.tick_bytes,
                collectives={k: (g.counts[k], g.bytes[k]) for k in g.counts},
                ticks=g.ticks, bubble=g.bubble)


def _pp_rank(rank: int, world: int, port: int, out_dir: str, names: list[str]) -> None:
    """Phase 16 in a spawned process: rank ``rank`` of ``world`` on the one
    card over gloo; every case of ``names``; rank 0 writes each case's
    results, every rank its launches, ms, memory, shifts and ticks."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), ETQ_DIST_BACKEND="gloo", LOCAL_RANK="0")
    import torch.distributed as dist

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import multihost

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    if not multihost.initialize_from_env(device="cuda", verbose=False):
        raise RuntimeError("no process group")
    try:
        batches = _flagship_batches(2, seed=PP_SEED)
        for spec in (s for s in PP_CASES if s[0] in names):
            res = _pp_run(spec, batches)
            keep = res if rank == 0 else {k: res[k] for k in (
                "loss", "launches", "ms", "peak_gib", "stage", "tick_bytes", "collectives",
                "ticks", "bubble")}
            torch.save(keep, os.path.join(out_dir, f"{spec[0]}.rank{rank}.pt"))
            del res, keep
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def pp_phase(tag: str) -> dict:
    """Phase 16: the DP x GPipe pipeline step (parallel/pipeline.py) on the
    one card, its ranks spawned over gloo, each case against the
    one-process step of the same state, batches and seed.  Returns the
    launches of rank 0's step in case "a bf16"."""
    import tempfile

    from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
        apply_updates,
    )

    print(f"pipeline step: {len(PP_CASES)} cases at (data, pipe) ranks on the one card over "
          f"gloo (gloo copies CUDA tensors through the host; the ranks share one card: no "
          f"times below are a pipeline speed)  [{tag}]", flush=True)
    batches = _flagship_batches(2, seed=PP_SEED)
    refs = {}
    for spec in PP_CASES:
        refs[spec[0]] = _pp_reference(spec, batches)
        if spec[2] == "bf16":   # the one-process step against itself: the card's spread
            again = _pp_reference(spec, batches)
            refs[spec[0]]["spread"] = _rel_l2(again["grads"], refs[spec[0]]["grads"])
            del again
        torch.cuda.empty_cache()
    del batches
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for world in (2, 3, 4):
            names = [s[0] for s in PP_CASES if s[1][0] * s[1][1] == world]
            t = time.perf_counter()
            _spawn(_pp_rank, world, world, _free_port(), tmp, names, timeout=PP_TIMEOUT_S)
            print(f"pipeline step: {world} ranks, cases {names}: the spawned group took "
                  f"{time.perf_counter() - t:.1f} s  [{tag}]", flush=True)
        for spec in PP_CASES:
            name, (data, pipe), dt = spec
            ranks = [torch.load(os.path.join(tmp, f"{name}.rank{r}.pt"), weights_only=False)
                     for r in range(data * pipe)]
            got, want = ranks[0], refs[name]
            lim_loss, lim_grad = DP_LIMITS[DP_DTYPES[dt]]
            errs = dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                        **{k: abs(got["metrics"][k] - want["metrics"][k])
                           / abs(want["metrics"][k]) for k in want["metrics"]},
                        energy=_rel_l2({"e": got["energy"]}, {"e": want["energy"]}),
                        forces=_rel_l2({"f": got["forces"]}, {"f": want["forces"]}),
                        grads=_rel_l2(got["grads"], want["grads"]))
            # the update on identical gradients (phase 7): the one-process
            # optimizer and EMA from the ranks' gathered gradients
            replay = _tp_state(_pp_spec(dt))
            for n, p in replay.model.named_parameters():
                p.grad = got["grads"][n].to("cuda")
            apply_updates(replay)
            dp_ = max(float((got["params"][n] - p.detach().cpu()).abs().max())
                      for n, p in replay.model.named_parameters())
            de_ = max(float((got["ema"][n] - e.cpu()).abs().max())
                      for n, e in replay.ema.items())
            del replay
            print(f"pipeline ({name}): data={data} pipe={pipe}; loss {got['loss']:.6f} vs one "
                  f"process {want['loss']:.6f}; rel errs "
                  f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (limits loss and "
                  f"metrics {lim_loss:.0e}, energies, forces and gradients {lim_grad:.0e} "
                  f"relative L2); on the ranks' gradients, after the step: masters max |diff| "
                  f"{dp_:.2e}, EMA {de_:.2e} (limit {1e-2 * TP_LR:.1e} = 1e-2 lr); one process "
                  f"{want['ms']:.1f} ms, peak {want['peak_gib']:.2f} GiB"
                  + (f"; two one-process steps differ by {want['spread']:.2e} in their "
                     f"gradients (relative L2)" if "spread" in want else "")
                  + f"  [{tag}]", flush=True)
            for r, res in enumerate(ranks):
                n_shift, b_shift = res["collectives"]["shift"]
                print(f"  rank {r} (stage {r % pipe}, blocks {res['stage'][0]}-"
                      f"{res['stage'][1] - 1}): step {res['ms']:.1f} ms, peak "
                      f"{res['peak_gib']:.2f} GiB; ring shift {res['tick_bytes'] / 1e6:.2f} MB "
                      f"a forward tick, {n_shift} shifts and {b_shift / 1e6:.1f} MB in the "
                      f"step (this rank's inputs to the all-gathers); {res['ticks']} ticks, "
                      f"{res['bubble']} of them bubble; collectives (count, bytes) "
                      f"{res['collectives']}; launches {res['launches']}  [{tag}]", flush=True)
            if not (max(errs[k] for k in ("loss", "energy_l1", "force_l1")) <= lim_loss
                    and max(errs[k] for k in ("energy", "forces", "grads")) <= lim_grad
                    and dp_ <= 1e-2 * TP_LR and de_ <= 1e-2 * TP_LR):
                raise RuntimeError(f"phase 16 {name}: the pipeline step disagrees with the "
                                   "one-process step")
            if any(r["loss"] != got["loss"] for r in ranks):
                raise RuntimeError(f"phase 16 {name}: the ranks' losses differ")
            idle = [(i, k) for i, r in enumerate(ranks) for k in PP_NEED
                    if r["launches"][k] == 0]
            if idle:
                raise RuntimeError(f"phase 16 {name}: kernels never launched on a stage "
                                   f"(rank, kernel): {idle}")
        launches = torch.load(os.path.join(tmp, "a bf16.rank0.pt"),
                              weights_only=False)["launches"]
    return launches


def _train_counters() -> dict:
    """The launch counters of the flagship's paths: K1's four kinds, K2a-c,
    K5a-c."""
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        gata_value,
        rotate_dense,
        s2act,
    )

    return {**{f"rotate_pairs.{k}": (rotate_dense.launches, k) for k in rotate_dense.launches},
            **{f"s2act.{k}": (s2act.launches, k) for k in s2act.launches},
            **{f"gata_value.{k}": (gata_value.launches, k) for k in gata_value.launches}}


def main(argv: list[str]) -> int:
    rotation_only = argv == ["--rotation-only"]
    s2act_only = argv == ["--s2act-only"]
    composite_only = argv == ["--composite-only"]
    pipeline_only = argv == ["--pipeline-only"]
    remat_only = argv == ["--remat-only"]
    gata_value_only = argv == ["--gata-value-only"]
    if argv and not (rotation_only or s2act_only or composite_only or pipeline_only
                     or remat_only or gata_value_only):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
        FLAGSHIP,
        EquiformerV2MatPES,
        init_weights,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import as_tensors
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops.cuda import (
        build,
        rotate,
        rotate_dense,
        s2act,
        so2conv,
    )
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.profiling import (
        oc20_batch,
        random_structures,
    )

    tag = card()
    print(tag, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}  [{tag}]", flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    built = build.build()
    for name in build.SOURCES:
        build.library(name)
    how = (f"{len(built)} nvcc in parallel" if built
           else "already built in this checkout")
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({how})  [{tag}]", flush=True)
    for name, rep in build.ptxas_report.items():
        regs = [r["registers"] for r in rep]
        spills = [f"{r['name']} {r['spill_bytes']} B" for r in rep if r["spill_bytes"]]
        print(f"  ptxas {name}.cu: {len(rep)} kernel instances, {min(regs)}-{max(regs)} "
              f"registers, spill stores: {', '.join(spills) or 'none'}")
        for r in rep:  # the instances the serving and training paths run
            if r["name"].startswith(("pairs_kernel<f32,4,2,", "pairs_kernel<bf16,4,2,",
                                     "pairs_kernel<f32,4,4,", "pairs_kernel<bf16,4,4,",
                                     "s2act_tc_kernel<f32,25,", "s2act_tc_kernel<bf16,25,",
                                     "s2act_tc_kernel<f32,19,", "s2act_tc_kernel<bf16,19,",
                                     "so2conv_kernel<", "b_operand_kernel<", "rot_kernel<f32,6,2,",
                                     "rot_kernel<bf16,6,2,", "rot_kernel<f32,4,2,",
                                     "rot_kernel<bf16,4,2,", "gata_value_kernel<f32,4,",
                                     "gata_value_kernel<bf16,4,")) or re.search(
                                         r"s2act_tc_kernel<\w+,(49|29|14),", r["name"]):
                print(f"    {r['name']}: {r['registers']} registers, "
                      f"{r['spill_bytes']} B spill stores")

    # the serving model and its first request's batch
    model = EquiformerV2MatPES(**FLAGSHIP)
    init_weights(model, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    pred = Predictor(model, state, CUTOFF, MAX_NEIGHBORS, device="cuda")
    rng = np.random.default_rng(0)
    requests = [random_structures(rng, N_STRUCTURES, N_ATOMS) for _ in range(N_REQUESTS)]
    # phase 3's shapes: the first request in the fixed-degree layout (the
    # training phases' and the kernel table's rows); the Predictor serves
    # it ragged (phase 4, and phase 17 compares the two)
    from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.graph import collate

    pb = collate(_samples(requests[0]), CUTOFF, MAX_NEIGHBORS,
                 *fixed_degree_pads([N_ATOMS] * N_STRUCTURES, MAX_NEIGHBORS), fixed_degree=True)
    batch = as_tensors(pb, "cuda")
    rpb = pred.collate(requests[0])
    print(f"flagship request: {N_STRUCTURES} structures x {N_ATOMS} atoms; fixed-degree "
          f"N_pad {pb.pos.shape[0]}, E_pad {pb.edge_src.shape[0]}; ragged (the Predictor) "
          f"N_pad {rpb.pos.shape[0]}, E_pad {rpb.edge_src.shape[0]} "
          f"({int(pb.edge_mask.sum())} real edges)", flush=True)

    # phase 3: kernels against their plain versions
    e_qm9 = QM9_MOLECULES * QM9_ATOMS * (QM9_ATOMS - 1)
    oc20_vec = edge_vectors(as_tensors(oc20_batch(np.random.default_rng(7), OC20_GRAPHS,
                                                  OC20_ATOMS), "cuda"))
    if rotation_only:
        check_kernels(batch, e_qm9, tag, rotation_only=True)
        check_k4(edge_vectors(batch), oc20_vec, tag, rotation_only=True)
        print(f"rotation kernels checked and timed  [{tag}]")
        return 0
    if s2act_only:
        check_k2(int(pb.pos.shape[0]), tag)
        print(f"S2 activation kernels checked and timed  [{tag}]")
        return 0
    if gata_value_only:
        del pred
        print(json.dumps({"kernels": check_k5(tag)}))
        print(f"GATA value activation kernels checked and timed  [{tag}]")
        return 0
    if composite_only:
        del pred
        print(json.dumps({"kernels": tp_phase(batch, tag)}))
        print(f"composite step checked  [{tag}]")
        return 0
    if pipeline_only:
        del pred, batch
        torch.cuda.empty_cache()
        print(f"pipeline step checked, launches of rank 0's bf16 step {pp_phase(tag)}  "
              f"[{tag}]")
        return 0
    if remat_only:
        del pred, batch
        torch.cuda.empty_cache()
        remat_phase(_train_counters(), tag)
        print(f"remat step checked  [{tag}]")
        return 0
    records = check_kernels(batch, e_qm9, tag)
    records += check_k3(int(pb.edge_src.shape[0]), e_qm9, tag)
    records += check_k4(edge_vectors(batch), oc20_vec, tag)
    k2 = check_k2(int(pb.pos.shape[0]), tag)
    # K2c is not on the OC20 path (a first-order step): its OC20 instances
    # stay beside the flagship's K2c record
    next(r for r in k2 if r["name"] == "s2act.k3")["oc20_instances"] = [
        r for r in k2 if r["name"].startswith("s2act.k3[K=")]
    records += [r for r in k2 if not r["name"].startswith("s2act.k3[K=")]
    records += check_k5(tag)

    # phase 4: serve, counting launches from zero
    counters = _train_counters()
    k3_counters = {f"so2conv.{k}": (so2conv.launches, k) for k in so2conv.launches}
    for d, k in counters.values():
        d[k] = 0
    torch.cuda.reset_peak_memory_stats()
    for i, req in enumerate(requests):
        before = {n: d[k] for n, (d, k) in counters.items()}
        t = time.perf_counter()
        out = pred.predict_batch(req)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if out["energy"].shape != (N_STRUCTURES,) or not np.isfinite(out["energy"]).all():
            raise RuntimeError(f"request {i}: bad energies {out['energy']}")
        for f in out["forces"]:
            if f.shape != (N_ATOMS, 3) or not np.isfinite(f).all():
                raise RuntimeError(f"request {i}: bad forces of shape {f.shape}")
        per = {n: d[k] - before[n] for n, (d, k) in counters.items()}
        print(f"request {i}: {N_STRUCTURES} structures, {dt * 1e3:.1f} ms, "
              f"{N_STRUCTURES / dt:.1f} structures/s, launches {per}  [{tag}]", flush=True)
    launches = {n: d[k] for n, (d, k) in counters.items()}
    print(f"launches over {N_REQUESTS} requests: {launches}  [{tag}]", flush=True)
    print(f"peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB  "
          f"[{tag}]", flush=True)
    # K2c and K5c are grad-of-grad kernels: training runs them, serving never does
    idle = [n for n, c in launches.items()
            if c == 0 and n not in ("s2act.k3", "gata_value.k5c")]
    if idle:
        raise RuntimeError(f"kernels never launched on the serving path: {idle}")
    for r in records:
        r["launches_serving"] = launches.get(r["name"], 0)

    # phase 4b: the same request on the factored Wigner representation (K4)
    k4_request = factored_request_phase(pred, state, requests[0], tag)
    for r in records:
        r["launches_matpes_factored_request"] = k4_request.get(r["name"], 0)
        if r["name"].startswith("rotate."):   # K4's flagship sites run on this request
            for s in r["sites"]:
                if s["site"].startswith("flagship"):
                    s["launches_per_factored_request"] = k4_request[r["name"]]
    print(f"K4 launches per factored flagship request, by kind: {k4_request}  [{tag}]",
          flush=True)

    # phase 5: the card against the CPU plain path
    small = random_structures(np.random.default_rng(1), 4, N_ATOMS)
    gpu = pred.predict_batch(small)
    cpu_model = EquiformerV2MatPES(**FLAGSHIP)
    cpu = Predictor(cpu_model, state, CUTOFF, MAX_NEIGHBORS, device="cpu").predict_batch(small)
    e_rel = float(np.max(np.abs(gpu["energy"] - cpu["energy"]) / np.abs(cpu["energy"])))
    f_abs = float(max(np.abs(g - c).max() for g, c in zip(gpu["forces"], cpu["forces"])))
    f_max = float(max(np.abs(c).max() for c in cpu["forces"]))
    print(f"gpu vs cpu plain path (4 structures): energy max rel err {e_rel:.2e} "
          f"(limit 1e-4), forces max abs err {f_abs:.2e} (limit 1e-3; max |F| {f_max:.1f})  "
          f"[{tag}]", flush=True)
    if not (e_rel <= 1e-4 and f_abs <= 1e-3):
        raise RuntimeError("the card disagrees with the CPU plain path")
    del pred, cpu_model

    # phase 17: the ragged serving path against the fixed-degree batch, and
    # the kernels at the ragged request's shapes (their rows join the
    # kernels' JSON at the end, with the launches of one ragged request)
    ragged_rows = ragged_serving_phase(state, requests, tag)

    # phase 6: train, counting launches from zero over the timed steps
    train_launches = train_phase(counters, tag)
    for r in records:
        r["launches"] = train_launches.get(r["name"], 0)

    # phase 7: one f32 training step, the card against the CPU plain path
    train_parity_phase(tag)

    # phase 19: the bf16 step gives the same gradients twice
    determinism_phase(tag)
    # phase 18: a bf16 step in the uniform layout and on the blocks Wigner
    layout_step_phase(tag)
    # phase 20: the step with remat and inner_ckpt, at 16 x 30 and 64 x 30
    remat = remat_phase(counters, tag)
    for r in records:
        r["launches_remat_step"] = remat[("16 x 30", "remat")]["launches"].get(r["name"], 0)

    # phase 8: QM9 with K3 (K1 to / from, K2a / K2b at the edge site, the
    # FFNs and the heads, K3 at both conv sites), counting from zero
    qm9_counters = {**{f"rotate_pairs.{k}": (rotate_dense.launches, k)
                       for k in ("to", "from")},
                    **{f"s2act.{k}": (s2act.launches, k) for k in ("k1", "k2")},
                    **k3_counters}
    qm9_train, qm9_eval = qm9_phase(qm9_counters, tag)
    for r in records:
        r["launches_qm9_train"] = qm9_train.get(r["name"], 0)
        r["launches_qm9_eval"] = qm9_eval.get(r["name"], 0)
        if r["name"].startswith("so2conv."):
            r["launches"] = r["launches_qm9_train"]

    # phase 9: one f32 QM9 step, the card against the CPU plain path
    qm9_parity_phase(tag)

    # phase 10: OC20 with K4 (and the dense arm with K1), K2a / K2b at
    # K = 49 and 29, counting from zero
    oc20_counters = {**{f"rotate.{k}": (rotate.launches, k) for k in rotate.launches},
                     **{f"rotate_pairs.{k}": (rotate_dense.launches, k) for k in ("to", "from")},
                     **{f"s2act.{k}": (s2act.launches, k) for k in s2act.launches},
                     **{f"s2act.{k}[K={K}]": (s2act.launches_by_k, (k, K))
                        for k in ("k1", "k2") for K in (49, 29)}}
    oc20_train, oc20_dense, oc20_eval = oc20_phase(oc20_counters, tag)
    for r in records:
        r["launches_oc20_train"] = oc20_train.get(r["name"], 0)
        r["launches_oc20_train_dense"] = oc20_dense.get(r["name"], 0)
        r["launches_oc20_eval"] = oc20_eval.get(r["name"], 0)
        if r["name"] in ("rotate.to", "rotate.from") or "[K=" in r["name"]:
            r["launches"] = r["launches_oc20_train"]
        elif r["name"] in ("rotate.to_m0", "rotate.from_m0"):
            r["launches"] = r["launches_matpes_factored_request"]

    # phase 11: one f32 OC20 step, the card against the CPU plain path
    oc20_parity_phase(tag)

    # phase 12: MatPES beyond the synthetic config.  12a: the baseline
    # config's bf16 stress step at full width, counting from zero: K1 to /
    # from and K2a-c at K = 19 (its edge site) must launch
    base_counters = {**{f"rotate_pairs.{k}": (rotate_dense.launches, k) for k in ("to", "from")},
                     **{f"s2act.{k}[base]": (s2act.launches_by_k, (k, 19))
                        for k in ("k1", "k2", "k3")}}
    base_train = baseline_phase(base_counters, tag)
    for r in records:
        r["launches_baseline_train"] = base_train.get(r["name"], 0)
        if r["name"].endswith("[base]"):
            r["launches"] = r["launches_baseline_train"]
    # 12b: one f32 baseline stress step, the card against the CPU plain path
    baseline_parity_phase(tag)
    # 12c: the flagship step with each GATA-V2 option
    options_phase(tag)
    # 12d: the fixture config's checkpoint, evaluated on the card and the CPU
    fixture_phase(tag)

    # phase 13: the MatPES variant family.  13a: every registry preset,
    # one request and one bf16 step each, counting from zero per call
    presets = variants_phase(tag)
    gata_v1 = presets["equiformer_v2_matpes_gata"]["training"]
    for r in records:
        r["launches_presets"] = {n: p["training"].get(r["name"], 0)
                                 for n, p in presets.items()}
        if r["name"].endswith("[4,4]"):   # the GATA v1 preset's step is their main path
            r["launches"] = gata_v1[r["name"]]
    # 13b: the headline preset at full width: serving, timed steps, profile
    headline = headline_phase(tag)
    for r in records:
        r["launches_headline_train"] = headline["launches"].get(r["name"], 0)
    # 13c: the card against the CPU for the headline preset, GATA v1 and MoE
    variant_parity_phase(tag)

    # phase 14: data-parallel training, counting (a)'s step from zero
    dp_launches = dp_phase(counters, tag)
    for r in records:
        r["launches_dp_step"] = dp_launches.get(r["name"], 0)

    # phase 15: the composite DP x TP x EP x SP step; its kernel rows at the
    # sharded shapes count rank 0's launches in its step
    records += tp_phase(batch, tag)

    # phase 16: the DP x GPipe pipeline step; the flagship's kernel rows
    # record the launches of rank 0's bf16 step (stage 0 of 2)
    pp_launches = pp_phase(tag)
    for r in records:
        r["launches_pipeline_step_rank0"] = pp_launches.get(r["name"], 0)

    records += ragged_rows
    print(json.dumps({"kernels": records}))
    print(tag)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
