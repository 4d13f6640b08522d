"""Training cells: the program's padded loader feeds the training step that
the configuration names (``program.train_step``, called with the ``train``
keys in ``step_args``), each step on the card.

Set-up builds the model (``program.model``) and the train state once, draws
the float32 master weights from the seed, and drives the first
``check_steps`` steps through the window's own loader and step; the window
then continues the same state and loader.  After the window (and the memory
peak) the state is freed and the plain reference follows those first steps
from the same weights on the same structures: losses, the first gradient as
the optimizer receives it, the change of the parameters and of the EMA, and
the neighbour graphs of the batches.
"""

from __future__ import annotations

import gc

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from time import perf_counter as now

from ..harness.common import (PKG, Phases, draw_weights, graph_mismatch, leaf_gap, leaf_gaps,
                              program, program_model, reference_model)
from ..harness.readings import Readings
from ..harness.trace import profile
from ..reference.train import Trainer
from ..traffic import labelled_pool


class _Recorded:
    """The pool as the program's dataset, recording the order it is read in."""

    def __init__(self, samples):
        self.samples = samples
        self.order: list[int] = []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.order.append(int(i))
        return self.samples[i]


def build(config: dict, device):
    """The program's model for training, as the configuration states it,
    built on the host and moved to ``device``; its initial weights are
    overwritten."""
    tr = config["train"]
    return program_model(config, tr["compute_dtype"], tr["layout"]).to(device)


class FirstGradient:
    """The per-leaf norms of the gradient that the first optimizer step
    receives (after the program's clip), read by a hook that runs before
    any ``torch.optim`` optimizer's step; where no such step ran, the
    parameters' ``.grad`` after the first training step."""

    def __init__(self, named_params: dict):
        self.named = named_params
        self.norms: dict = {}
        self.source = "none"
        self._hook = register_optimizer_step_pre_hook(self._pre_step)

    def _pre_step(self, optimizer, args, kwargs):
        if self.norms:
            return
        mine = {id(p) for g in optimizer.param_groups for p in g["params"]}
        self.norms = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                      for n, p in self.named.items() if id(p) in mine}
        self.source = "optimizer step hook"

    def close(self) -> None:
        """After the first training step: stop listening; fall back to
        ``.grad`` where the hook saw nothing."""
        self._hook.remove()
        if not self.norms:
            self.norms = {n: float(p.grad.norm()) if p.grad is not None else 0.0
                          for n, p in self.named.items()}
            self.source = ".grad after the step"


# a leaf whose reference gradient is under this share of the median leaf's
# is left out of the parameter and EMA changes
MOVED = 1e-3


def norms(W: dict, w0_host: dict, device) -> dict:
    """Per-leaf norm of the change from ``w0_host``."""
    return {n: float((W[n].detach() - w0_host[n].to(device)).norm()) for n in w0_host}


def compare(prog_loss, first_grad, change, ema_change, ref: Trainer, w0_host: dict,
            device) -> tuple[dict, dict]:
    """The compared numbers of the first steps against the reference ``ref``
    after them: the worst step's relative loss gap; the worst leaf's gap in
    the norm of the first (clipped) gradient (``grad_gap``) and the median
    leaf's (``grad_gap_median``: steady where one small leaf's gradient is a
    sum of signs, as an L1 loss's output bias), of the parameters' change and
    of the EMA's change (``common.leaf_gap``).  A cell's limits name the
    numbers it compares.  The changes leave out leaves
    whose reference gradient is below a thousandth of the median leaf's
    (``MOVED``: unused parameters, and those whose gradient is nought to
    rounding, which Adam moves by round-off alone); ``info`` names each with
    its gradient over the median's."""
    ref_grad = {n: float(g.norm()) for n, g in ref.first_grad.items()}
    ref_change, ref_ema = norms(ref.W, w0_host, device), norms(ref.ema, w0_host, device)
    med = float(np.median(list(ref_grad.values())))
    moved = {n for n in ref_grad if ref_grad[n] >= MOVED * med}
    grad = leaf_gap(first_grad, ref_grad)
    update = leaf_gap(change, ref_change, moved)
    numbers = {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog_loss, ref.losses)),
        "grad_gap": grad[0],
        "grad_gap_median": float(np.median(list(leaf_gaps(first_grad, ref_grad).values()))),
        "update_gap": update[0],
        "ema_gap": leaf_gap(ema_change, ref_ema, moved)[0],
    }
    left_out = {n: float(f"{ref_grad[n] / med:.3g}") for n in ref_grad if n not in moved}
    info = dict(prog_loss=prog_loss, ref_loss=ref.losses, grad_gap=grad[0],
                worst_grad_leaf=grad[1], worst_update_leaf=update[1], leaves=len(ref_grad),
                moved=len(moved), left_out=left_out)
    return numbers, info


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

    pool = labelled_pool.generate(tr, seed)
    stress = float(opt.get("w_stress", 0.0)) > 0.0
    data = _Recorded([graph_mod.GraphSample(
        atomic_numbers=s["z"], pos=s["pos"], cell=s["cell"], pbc=True, energy=s["energy"],
        forces=s["forces"], stress=s.get("stress", np.zeros(6, np.float32)) if stress else None)
        for s in pool])
    B, slots = int(tr["structures_per_step"]), int(tr["node_slots"])
    n_pad = B * slots
    fixed = opt["layout"] == "fixed_degree"
    loader = loader_mod.PaddedLoader(data, B, cutoff, k, n_pad, n_pad * k, shuffle=True,
                                     seed=seed, prefetch=int(tr["prefetch"]),
                                     fixed_degree=fixed)
    phases.mark("pool")

    def batches():
        epoch = 0
        while True:
            loader.set_epoch(epoch)
            yield from loader
            epoch += 1

    feed = batches()

    def one_step():
        t = now()
        pb = next(feed)
        wait = now() - t
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
        shapes_w.append((n_pad, n_pad * k, int(pb.node_mask.sum()), int(pb.edge_mask.sum())))
        if now() - t0 >= seconds:
            break
    sync()
    window_s = now() - t0
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    failed_graphs = B * sum(not bool(a) for a in accepted)

    readings = Readings(mk, cfg["outputs"], "train", opt["compute_dtype"], window_s, shapes_w,
                        loader_wait_s=waits, counts=cfg.get("counts", "ops"))
    if trace:
        held = []

        def traced():
            pb, _, _ = one_step()
            held.append(pb)

        readings.slice = profile(traced, 1, sync)
        readings.slice_shapes = [(n_pad, n_pad * k, int(p.node_mask.sum()),
                                  int(p.edge_mask.sum())) for p in held]

    # free the program's state, then the reference
    del state, optim, step, model, params, feed, loader
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    structs = [pool[i] for i in order]
    ref = Trainer(reference_model(cfg), w0_host, opt, cutoff, k, dev,
                  int(tr["reference_graphs_per_block"]))
    mismatch = 0
    for i in range(n_check):
        batch = structs[i * B:(i + 1) * B]
        mismatch += graph_mismatch(checked[i], [(s["pos"], s["cell"]) for s in batch], cutoff,
                                   k)
        ref.step(batch)
    numbers, info = compare(prog_loss, first.norms, change, ema_change, ref, w0_host, dev)
    numbers["graph_mismatch"] = float(mismatch)
    info.update(first_gradient=first.source, setup=str(phases))
    attempted = len(waits) * B
    metrics = {
        "train_graphs_per_s": attempted / window_s,
        "setup_s": setup_s,
        "peak_mem_gib": peak / 2 ** 30,
    }
    return dict(numbers=numbers, info=info, metrics=metrics, readings=readings,
                attempted=attempted, failed=failed_graphs, peak=peak)
