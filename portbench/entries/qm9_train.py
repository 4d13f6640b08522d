"""Training cells of molecules with stacked targets (QM9): the program's
padded loader feeds the training step that the configuration names
(``program.train_step`` with the ``train`` keys in ``step_args``), each
step on the card.

As ``entries/train.py``, with molecules (``traffic/molecules.py``: no
cell, ``y`` targets) in place of labelled crystals.  The pads come from the
program's rule (``data/loader.py:infer_pad_sizes`` in the configuration's
layout) over the whole pool drawn from the traffic's ``pads_seed``: a
deployment sizes its pads once from its dataset, so every run seed trains
at the same shapes.  The plain reference (``reference/qm9.py``) follows the
first ``check_steps`` steps from the same weights on the same molecules:
losses, the first gradient as the optimizer receives it, the change of the
parameters and of the EMA, the neighbour graphs of the batches; and the
atoms and edges the loader dropped for want of room (``overflow``) over
every step of the run.
"""

from __future__ import annotations

import gc

import torch

from time import perf_counter as now

from ..harness.common import (PKG, Phases, draw_weights, graph_mismatch, program,
                              reference_model)
from ..harness.readings import Readings
from ..harness.trace import profile
from ..reference.qm9 import MOLECULE_CELL, Trainer
from ..traffic import molecules
from .train import FirstGradient, _Recorded, build, compare, norms


def samples(graph_mod, pool: list[dict]) -> list:
    """The pool as the program's molecules (no cell, no periodicity)."""
    return [graph_mod.GraphSample(atomic_numbers=m["z"], pos=m["pos"], cell=None, pbc=False,
                                  y=m["y"]) for m in pool]


def pads(loader_mod, graph_mod, cell) -> tuple[int, int]:
    """(n_pad, e_pad) by the program's rule over the whole ``pads_seed`` pool."""
    cfg, tr = cell.config, cell.traffic
    data = samples(graph_mod, molecules.generate(tr, int(tr["pads_seed"])))
    return loader_mod.infer_pad_sizes(data, cfg["model"]["cutoff"], cfg["max_neighbors"],
                                      int(tr["structures_per_step"]), sample=len(data),
                                      fixed_degree=cfg["train"]["layout"] == "fixed_degree")


def run(cell, seed: int, seconds: float, trace: bool, device, phases: Phases) -> dict:
    from importlib import import_module

    loader_mod = import_module(f"{PKG}.data.loader")
    graph_mod = import_module(f"{PKG}.data.graph")
    trainer = import_module(f"{PKG}.train.trainer")
    schedules = import_module(f"{PKG}.train.schedules")
    phases.mark("imports")

    cfg, tr = cell.config, cell.traffic
    mk, opt = cfg["model"], cfg["train"]
    cutoff, k = mk["cutoff"], cfg["max_neighbors"]
    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if is_cuda else (lambda: None)

    model = build(cfg, dev)
    phases.mark("model")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    w0 = draw_weights(shapes, seed, dev)
    model.load_state_dict(w0)
    w0_host = {n: t.cpu() for n, t in w0.items()}
    del w0
    phases.mark("weights")
    optim = trainer.GuardedAdamW(
        model.named_parameters(),
        schedules.warmup_cosine(opt["lr"], opt["warmup_steps"], opt["total_steps"]),
        opt["weight_decay"], opt["grad_clip"])
    state = trainer.create_train_state(model, optim)
    step = program(cfg["program"]["train_step"])(state, **{a: opt[a] for a in opt["step_args"]})
    phases.mark("optimizer")

    pool = molecules.generate(tr, seed)
    data = _Recorded(samples(graph_mod, pool))
    B = int(tr["structures_per_step"])
    n_pad, e_pad = pads(loader_mod, graph_mod, cell)
    loader = loader_mod.PaddedLoader(data, B, cutoff, k, n_pad, e_pad, shuffle=True, seed=seed,
                                     prefetch=int(tr["prefetch"]),
                                     fixed_degree=opt["layout"] == "fixed_degree")
    phases.mark("pool")

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    feed = batches()
    dropped = []

    def one_step():
        t = now()
        pb = next(feed)
        wait = now() - t
        dropped.append(pb.overflow_atoms + pb.overflow_edges)
        _, met = step(graph_mod.as_tensors(pb, dev))
        return pb, wait, met

    # set-up: the first steps, through the window's loader and step
    n_check = int(tr["check_steps"])
    params = dict(model.named_parameters())
    prog_loss, checked = [], []
    first = FirstGradient(params)
    for i in range(n_check):
        pb, _, met = one_step()
        prog_loss.append(float(met["loss"]))
        checked.append(pb)
        if i == 0:
            first.close()
            phases.mark("first step")
    change, ema_change = norms(params, w0_host, dev), norms(state.ema, w0_host, dev)
    order = list(data.order[:n_check * B])
    sync()
    phases.mark("check steps")
    setup_s = now() - phases.t_start

    # the window; refused updates are counted once it has closed
    waits, shapes_w, accepted = [], [], []
    t0 = now()
    while True:
        pb, wait, met = one_step()
        waits.append(wait)
        accepted.append(met["accepted"])
        shapes_w.append((n_pad, e_pad, int(pb.node_mask.sum()), int(pb.edge_mask.sum())))
        if now() - t0 >= seconds:
            break
    sync()
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    failed_graphs = B * sum(not bool(a) for a in accepted)

    readings = Readings(mk, cfg["outputs"], "train", opt["compute_dtype"], window_s, shapes_w,
                        loader_wait_s=waits, counts=cfg["counts"])
    if trace:
        held = []

        def traced():
            pb, _, _ = one_step()
            held.append(pb)

        readings.slice = profile(traced, 1, sync)
        readings.slice_shapes = [(n_pad, e_pad, int(p.node_mask.sum()), int(p.edge_mask.sum()))
                                 for p in held]

    # free the program's state, then the reference
    del state, optim, step, model, params, feed, loader
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    mols = [pool[i] for i in order]
    ref = Trainer(reference_model(cfg), w0_host, opt, cutoff, k, dev,
                  int(tr["reference_graphs_per_block"]))
    mismatch = 0
    for i in range(n_check):
        batch = mols[i * B:(i + 1) * B]
        mismatch += graph_mismatch(checked[i], [(m["pos"], MOLECULE_CELL) for m in batch],
                                   cutoff, k)
        ref.step(batch)
    numbers, info = compare(prog_loss, first.norms, change, ema_change, ref, w0_host, dev)
    numbers["graph_mismatch"] = float(mismatch)
    numbers["overflow"] = float(sum(dropped))
    real_edges = sum(s[3] for s in shapes_w) / len(shapes_w)
    info.update(first_gradient=first.source, setup=str(phases), n_pad=n_pad, e_pad=e_pad,
                edge_fill=real_edges / e_pad)
    attempted = len(waits) * B
    metrics = {
        "train_graphs_per_s": attempted / window_s,
        "setup_s": setup_s,
        "peak_mem_gib": peak / 2 ** 30,
    }
    return dict(numbers=numbers, info=info, metrics=metrics, readings=readings,
                attempted=attempted, failed=failed_graphs, peak=peak)
