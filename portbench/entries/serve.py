"""Serving cells: a closed loop of ``clients`` = 1 waiting client, as a
relaxation, screening or molecular-dynamics code that sends its next
request when the last answer is back, drives the program's
``Predictor.predict_batch`` (energies and forces of a ragged request) through
the traffic's ``requests`` requests in the seed's order, and round again; a
request's latency runs from the call to its answer on the host.

Set-up builds the model (``program.model``, float32, the serving layout),
draws its weights from the seed, and serves the seed's largest request and
two others once, so the caching allocator holds its peak before the window.
After the window the model is freed and the plain reference recomputes a
sample of the answered requests, drawn from the seed with the largest among
them: the neighbour graphs, the energies and the forces.
"""

from __future__ import annotations

import gc
import sys

import numpy as np
import torch

from time import perf_counter as now

from ..harness.common import (PKG, Phases, draw_weights, graph_mismatch, program_model,
                              reference_model)
from ..harness.readings import Readings
from ..harness.trace import profile
from ..harness.window import percentile
from ..reference.neighbors import neighbor_list
from ..traffic import mixed_requests


def reference_request(ref, W: dict, req: list, cutoff: float, k: int, device):
    """Per-structure energies and forces of one request by the reference."""
    z, pos, gi, src, dst, sh = [], [], [], [], [], []
    off = 0
    for b, s in enumerate(req):
        a, d, c = neighbor_list(s["positions"], s["cell"], cutoff, k)
        src.append(a + off)
        dst.append(d + off)
        sh.append(c)
        z.append(s["atomic_numbers"])
        pos.append(s["positions"])
        gi.append(np.full(len(s["positions"]), b))
        off += len(s["positions"])

    def t(x, dt):
        return torch.as_tensor(np.concatenate(x), device=device).to(dt)

    batch = dict(z=t(z, torch.long), pos=t(pos, torch.float32), graph=t(gi, torch.long),
                 cell=torch.as_tensor(np.stack([s["cell"] for s in req]), device=device).float(),
                 src=t(src, torch.long), dst=t(dst, torch.long), shift=t(sh, torch.float32),
                 natoms=torch.as_tensor([len(s["positions"]) for s in req], device=device))
    out = ref.energy_forces(W, batch)
    return out["energy"].detach().cpu().numpy(), out["forces"].detach().cpu().numpy()


def run(cell, seed: int, seconds: float, trace: bool, device, phases: Phases) -> dict:
    from importlib import import_module

    inference = import_module(f"{PKG}.inference")
    phases.mark("imports")

    cfg, tr = cell.config, cell.traffic
    mk, cutoff, k = cfg["model"], cfg["model"]["cutoff"], cfg["max_neighbors"]
    sv = cfg["serve"]
    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if is_cuda else (lambda: None)
    if int(tr["clients"]) != 1:
        raise NotImplementedError("the serving entry drives one client")

    model = program_model(cfg, sv["compute_dtype"], sv["layout"])    # on the host
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    weights = draw_weights(shapes, seed, dev)
    pred = inference.Predictor(model, weights, cutoff, k, sv["energy_mean"], sv["energy_std"],
                               device=dev)
    w_host = {n: t.cpu() for n, t in weights.items()}
    del weights
    phases.mark("model")

    n_req = int(tr["requests"])
    requests = mixed_requests.generate(tr, seed, n_req)
    atoms = [sum(len(s["positions"]) for s in r) for r in requests]
    phases.mark("requests")

    collate_s, collated = [], {}
    plain_collate = pred.collate

    def timed_collate(structures):
        t = now()
        pb = plain_collate(structures)
        collate_s.append(now() - t)
        collated[id(structures)] = pb
        return pb

    pred.collate = timed_collate
    for i in sorted(range(n_req), key=lambda i: -atoms[i])[:1] + [0, n_req - 1]:
        pred.predict_batch(requests[i])
    sync()
    collate_s.clear()
    collated.clear()
    phases.mark("warm-up")
    setup_s = now() - phases.t_start

    # the window: one client, each request sent when the last answer is back
    answers, graphs, latency, shapes_w = {}, {}, [], []
    sent = structures = 0
    t0 = now()
    while True:
        j = sent % n_req
        req = requests[j]
        sent += 1
        start = now()
        try:
            out = pred.predict_batch(req)
        except RuntimeError as e:   # an unanswered request fails the run's check
            print(f"request {j} failed: {e}", file=sys.stderr)
        else:
            latency.append(now() - start)
            structures += len(req)
            pb = collated[id(req)]
            answers.setdefault(j, out)
            graphs.setdefault(j, pb)
            shapes_w.append((len(pb.atomic_numbers), len(pb.edge_mask),
                             int(pb.node_mask.sum()), int(pb.edge_mask.sum())))
        if now() - t0 >= seconds:
            break
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0

    readings = Readings(mk, cfg["outputs"], "serve", sv["compute_dtype"], window_s, shapes_w,
                        collate_s=list(collate_s), service_s=list(latency),
                        counts=cfg.get("counts", "ops"))
    if trace:
        traced = list(range(min(int(tr["traced_requests"]), n_req)))
        readings.slice = profile(lambda: [pred.predict_batch(requests[i]) for i in traced],
                                 len(traced), sync)
        readings.slice_shapes = [
            (len(p.atomic_numbers), len(p.edge_mask), int(p.node_mask.sum()),
             int(p.edge_mask.sum()))
            for p in (collated[id(requests[i])] for i in traced)]

    # free the program, then the reference on a sample of the answers
    del pred, model, collated
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    rng = np.random.default_rng(seed)
    done = sorted(answers)
    largest = max(done, key=lambda i: atoms[i]) if done else None
    others = [i for i in done if i != largest]
    n_sample = min(int(tr["check_requests"]) - 1, len(others))
    sample = ([largest] if done else []) + [others[j] for j in
                                            rng.choice(len(others), n_sample, replace=False)]
    ref = reference_model(cfg)
    W = {n: t.to(dev) for n, t in w_host.items()}
    e_gap, f_gap, mismatch, e_scale = 0.0, 0.0, 0, 0.0
    for i in sample:
        req, ans = requests[i], answers[i]
        e_ref, f_ref = reference_request(ref, W, req, cutoff, k, dev)
        e_ref = e_ref * sv["energy_std"] + sv["energy_mean"]
        e_scale = max(e_scale, float(np.abs(e_ref).max()))
        e_gap = max(e_gap, float(np.abs(ans["energy_per_atom"] - e_ref).max()))
        f_got = np.concatenate(ans["forces"]) if ans["forces"] else np.zeros((0, 3))
        f_ref = f_ref * sv["energy_std"]
        f_gap = max(f_gap, float(np.linalg.norm(f_got - f_ref) / max(np.linalg.norm(f_ref),
                                                                      1e-30)))
        mismatch += graph_mismatch(graphs[i], [(s["positions"], s["cell"]) for s in req],
                                   cutoff, k)
    numbers = {
        "energy_gap": e_gap / max(e_scale, 1e-30) if sample else float("nan"),
        "force_gap": f_gap if sample else float("nan"),
        "graph_mismatch": float(mismatch),
        "unanswered": float(sent - len(latency)),
    }
    info = dict(sample=sample, sample_atoms=[atoms[i] for i in sample], sent=sent,
                distinct=len(answers), setup=str(phases),
                service_ms_median=1e3 * float(np.median(latency)) if latency else None)
    per_req = int(tr["structures_per_request"])
    metrics = {
        "serve_structures_per_s": structures / window_s,
        "serve_p95_ms": 1e3 * percentile(latency, 95) if latency else float("nan"),
        "setup_s": setup_s,
        "peak_mem_gib": peak / 2 ** 30,
    }
    return dict(numbers=numbers, info=info, metrics=metrics, readings=readings,
                attempted=sent * per_req, failed=sent * per_req - structures, peak=peak)
