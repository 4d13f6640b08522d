"""Data-parallel training: one process per GPU, one all-reduce a step.

Port of the JAX package's parallel/data_parallel.py (the reference's DDP
trainer, models/train_oc20v2_parallel.py:34-54, 430-436).  JAX gives every
device of a ``data`` mesh axis its own padded micro-batch and averages the
gradients and metrics with ``pmean`` inside ``shard_map``; here every
process (rank) runs its ``n_local = data / world`` micro-batches one after
another and the ranks average with one ``all_reduce``:

* the gradient of a step is the mean over all ``data`` micro-batches of
  each micro-batch's loss gradient (JAX ``pmean``), not the gradient of one
  loss over their concatenation; the metrics are averaged the same way;
* each micro-batch's gradients (zeros for a parameter it does not reach,
  so that every rank's buffer has one layout) are summed into one flat
  float32 buffer, with the metrics at its end; one
  ``all_reduce(SUM)`` of that buffer, a division by ``data``, and the
  means are copied back into the masters' ``.grad``;
* then ``train/trainer.py:apply_updates`` (guarded AdamW, EMA, step count)
  runs on every rank on the same averaged gradients, so the guard takes or
  skips a step on all ranks together and the replicas stay bit-identical
  (its one host sync a step stays one);
* at set-up rank 0 broadcasts the parameters, the EMA and the optimizer
  state (JAX replicates them by construction, ``in_specs P()``).

Not ``DistributedDataParallel``: its reducer fires from hooks during
``.backward()``, while the MatPES force path runs ``torch.autograd.grad``
with ``create_graph=True`` inside the forward; JAX averages once, after the
whole loss gradient, and so does this step.  Dropout masks come from the
generator each rank's ``loss_grad`` holds (the trainers seed it from the
seed and the rank; JAX splits one key per device).  Whatever step the
single-process trainer builds is wrapped, so a bf16 model trains in bf16
here too, with the gradients on the f32 masters and reduced in f32.

Without an initialized process group the step runs all ``data``
micro-batches in one process (no collective).  ``group`` (the ``data``
column of a ``parallel/sharding.py`` mesh) restricts the averaging and the
set-up broadcast to a subgroup of the processes.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..data.graph import as_tensors
from .multihost import process_count
from ..train.trainer import (
    TrainState,
    apply_updates,
    matpes_loss_grad,
    oc20_loss_grad,
    qm9_loss_grad,
)

__all__ = ["stack_microbatches", "microbatches", "DataParallelStep", "replicate",
           "make_qm9_dp_step", "make_oc20_dp_step", "make_matpes_dp_step", "rank_seed"]


def rank_seed(seed: int, rank: int) -> int:
    """The dropout generator's seed on ``rank``: ``seed`` itself on rank 0
    (so a one-process run keeps its masks), elsewhere a draw from
    ``SeedSequence((seed, rank))``."""
    return seed if rank == 0 else int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def stack_microbatches(batches: Sequence[dict]) -> dict:
    """Stack micro-batch dicts (tensors or numpy arrays) into one dict of
    tensors with a leading micro-batch axis."""
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches]) for k in batches[0]}


def microbatches(loader: Iterable, device, n_local: int, n_steps: int):
    """The loader's batches on ``device``, stacked ``n_local`` at a time, for
    ``n_steps`` steps.  Every rank must take the same number of steps (each
    one is a collective), so a caller passes the count of the smallest
    shard; the loader is read to its end all the same, and what is left
    over is dropped (the JAX trainer drops its ragged group too)."""
    buf, steps = [], 0
    for pb in loader:
        if steps == n_steps:
            continue
        buf.append(as_tensors(pb, device))
        if len(buf) == n_local:
            yield stack_microbatches(buf)
            buf, steps = [], steps + 1


@torch.no_grad()
def _broadcast_(tensors: list[torch.Tensor], device, src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, one broadcast per dtype
    (each flattened on ``device``, where the backend can reach it)."""
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1).to(device) for t in same])
        dist.broadcast(flat, src=src, group=group)
        for t, v in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(v.view_as(t))


def replicate(state: TrainState, group=None) -> None:
    """Make every rank's state (of ``group``, default all) that of the
    group's first rank: parameters, EMA, the AdamW moments and counts, the
    guard's counters and the step."""
    opt = state.optimizer
    device = opt.params[0].device
    adam = [t for p in opt.params for _, t in sorted(opt.opt.state.get(p, {}).items())
            if torch.is_tensor(t)]
    scalars = [{"n_adam": len(adam), "step": state.step, "count": opt.count,
                "notfinite_count": opt.notfinite_count, "total_notfinite": opt.total_notfinite,
                "last_finite": opt.last_finite}]
    mine = dict(scalars[0])
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(scalars, src=src, group=group, device=device)
    if scalars[0]["n_adam"] != mine["n_adam"]:
        raise RuntimeError(f"optimizer state differs between ranks: {mine['n_adam']} AdamW "
                           f"tensors here, {scalars[0]['n_adam']} on rank {src}")
    _broadcast_([*opt.params, *state.ema.values(), *adam], device, src, group)
    opt.count = int(scalars[0]["count"])
    opt.notfinite_count = int(scalars[0]["notfinite_count"])
    opt.total_notfinite = int(scalars[0]["total_notfinite"])
    opt.last_finite = bool(scalars[0]["last_finite"])
    state.step = int(scalars[0]["step"])


class DataParallelStep:
    """``step(stacked) -> (loss, metrics)``: ``stacked`` holds this rank's
    ``n_local`` micro-batches along a leading axis (``stack_microbatches``).
    Built around a trainer's ``*_loss_grad`` (the JAX package's
    ``make_dp_train_step_from_loss`` with ``_apply_updates_factory``).

    The three parts, which a caller may also run one by one:
    ``accumulate`` (the local sum of gradients and metrics in the flat
    buffer), ``reduce`` (the all-reduce and the division by ``data``) and
    ``finish`` (the means into ``.grad``, then ``apply_updates``).
    ``mean_grads()`` reads the last step's averaged gradients by name.
    ``group`` / ``group_size``: the processes that average (default all).
    """

    def __init__(self, state: TrainState, loss_grad: Callable, data: int,
                 ema_decay: float = 0.999, group=None, group_size: int | None = None):
        self.state, self.loss_grad, self.ema_decay = state, loss_grad, ema_decay
        named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        if [id(p) for p in self.params] != [id(p) for p in state.optimizer.params]:
            raise ValueError("the optimizer must hold the model's trainable parameters in "
                             "their order")
        if any(p.dtype != torch.float32 for p in self.params):
            raise ValueError("data-parallel training reduces float32 master gradients")
        self.group = group
        self.world = group_size or process_count()
        if data < 1 or data % self.world:
            raise ValueError(f"data={data} micro-batches do not split over {self.world} "
                             "processes")
        self.data, self.n_local = data, data // self.world
        self.sizes = [p.numel() for p in self.params]
        self.n_grad = sum(self.sizes)
        self.keys: list[str] | None = None   # the metric names, from the first step
        self.flat: torch.Tensor | None = None
        if dist.is_initialized():
            replicate(state, group)

    def accumulate(self, stacked: dict) -> torch.Tensor:
        """Run this rank's micro-batches; return the flat buffer holding the
        sums of their gradients, then of their loss and metrics."""
        n = next(iter(stacked.values())).shape[0]
        if n != self.n_local:
            raise ValueError(f"{n} micro-batches given, {self.n_local} expected on each of "
                             f"{self.world} processes (data={self.data})")
        for i in range(n):
            self._add(i, *self.loss_grad({k: v[i] for k, v in stacked.items()}))
        return self.flat

    def _add(self, i: int, loss: torch.Tensor, metrics: dict) -> None:
        """Copy (``i`` = 0) or add the gradients in ``.grad``, the loss and
        the metrics into the flat buffer."""
        if self.keys is None:
            self.keys = list(metrics)
            self.flat = torch.empty(self.n_grad + 1 + len(self.keys),
                                    device=self.params[0].device)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        tail = torch.stack([loss.float(), *(metrics[k].float() for k in self.keys)])
        views = [*self.flat[:self.n_grad].split(self.sizes), self.flat[self.n_grad:]]
        views = [v.view_as(t) for v, t in zip(views, [*grads, tail])]
        if i == 0:
            torch._foreach_copy_(views, [*grads, tail])
        else:
            torch._foreach_add_(views, [*grads, tail])

    def reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """Sum ``flat`` over the ranks (the step's one collective) and divide
        by ``data``, in place."""
        if dist.is_initialized():
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        return flat.div_(self.data)

    def finish(self, flat: torch.Tensor):
        """Copy the averaged gradients into ``.grad`` and apply the update;
        returns (loss, metrics) as the single-process step does."""
        for p, g in zip(self.params, flat[:self.n_grad].split(self.sizes)):
            p.grad = g.view_as(p).clone()
        loss, *values = flat[self.n_grad:].clone().unbind()
        info = apply_updates(self.state, self.ema_decay)
        return loss, {**dict(zip(self.keys, values)), "loss": loss, **info}

    def __call__(self, stacked: dict):
        return self.finish(self.reduce(self.accumulate(stacked)))

    def mean_grads(self) -> dict[str, torch.Tensor]:
        """The last step's averaged (unclipped) gradients, by parameter name."""
        return {n: g.view_as(p) for n, p, g in
                zip(self.names, self.params, self.flat[:self.n_grad].split(self.sizes))}


def make_qm9_dp_step(state: TrainState, data: int, loss_kind: str = "l1",
                     ema_decay: float = 0.999, generator: torch.Generator | None = None):
    """Data-parallel QM9 step."""
    return DataParallelStep(state, qm9_loss_grad(state, loss_kind, generator), data, ema_decay)


def make_oc20_dp_step(state: TrainState, data: int, w_energy: float = 2.0,
                      w_force: float = 100.0, ema_decay: float = 0.999,
                      generator: torch.Generator | None = None):
    """Data-parallel OC20 step: energy head + explicit force head,
    E-MSE x 2 + F-L1 x 100 (the reference's DDP trainer loss,
    train_oc20v2_parallel.py:143-217)."""
    return DataParallelStep(state, oc20_loss_grad(state, w_energy, w_force, generator), data,
                            ema_decay)


def make_matpes_dp_step(state: TrainState, data: int, w_energy: float = 1.0,
                        w_force: float = 1.0, w_stress: float = 0.0, ema_decay: float = 0.999,
                        generator: torch.Generator | None = None, inner_ckpt: bool = False):
    """Data-parallel MatPES step with autograd forces (and, with
    ``w_stress > 0``, the per-graph stress); ``inner_ckpt`` as
    ``train/trainer.py:make_matpes_train_step``."""
    return DataParallelStep(state, matpes_loss_grad(state, w_energy, w_force, w_stress,
                                                    generator, inner_ckpt=inner_ckpt),
                            data, ema_decay)
