"""Composite parallelism (DP x TP x EP x SP) over a (data, model) mesh of
processes.

Port of the JAX package's parallel/sharding.py.  There the step is one GSPMD
program: ``PartitionSpec``s say where each array lives and XLA inserts the
collectives.  Torch has no partitioner, so here the collectives are written
out, Megatron-style, and the numbers are those of the unsharded step (the
mean over the micro-batches of the energy + force (+ stress) loss, one
guarded AdamW update, the EMA):

* **Mesh.** Ranks are laid out as the JAX package lays out devices,
  ``reshape(world // M, M)``: rank = d M + m.  ``make_composite_mesh``
  makes one process group per data row (``model``, the M ranks of row d) and
  one per model column (``data``).
* **Regions.** ``ModelGroup`` holds the autograd functions that cross the
  ``model`` group.  Each backward calls another of them through ``.apply``,
  so the force loss's grad-of-grad crosses the collective again:
  ``copy_to`` (identity; backward all-reduce) <-> ``reduce_from``
  (all-reduce; backward identity), ``gather`` (all-gather; backward own
  slice) <-> ``scatter``, ``reduce_scatter`` (all-reduce, own slice;
  backward all-gather) <-> ``gather_to_partial`` (all-gather; backward
  reduce-scatter).  The reduce-scatter is an all-reduce and a slice, which
  every backend has.  ``torch.distributed.nn.functional.all_reduce`` is not
  used: its backward is another all-reduce, which multiplies the gradient
  of a replicated downstream by M.
* **TP / EP.** The modules declare their roles (nn/partition.py); at M > 1
  ``shard_state`` keeps each rank's share of every declared leaf, of the
  AdamW moments and of the EMA, and hands the modules the ``ModelGroup``.
  FFN: ``so3_linear_1`` and the gating scalars column-split over the hidden
  channels, the S2 activation on the rank's H/M channels, ``so3_linear_2``
  row-split then ``reduce_from``.  Attention: ``so2_conv_1`` column-split
  (the alpha logits of the rank's heads, its channels of each gate chunk
  and of each degree), alpha on the rank's heads (their head-mean by one
  ``reduce_from``), the GATA value activation on the rank's channels,
  ``so2_conv_2`` row-split then ``reduce_scatter`` onto the heads, alpha
  weighting, rotation back and the slot sum on the rank's heads, ``proj``
  row-split then ``reduce_from``.  MoE: the rank's experts, their weighted
  sum reduced.
* **SP** (``sp=True``): the padded edge axis is split evenly over
  ``model``, in any edge layout, where M divides E_pad and N_pad (the split
  GSPMD makes from the JAX package's ``batch_shardings``): rank r takes the
  edges [r E/M, (r+1) E/M) and owns the node rows [r N/M, (r+1) N/M)
  (``EdgeShard``).  The per-edge work (geometry, Wigner tables, radial
  MLPs, the edge-degree embedding, HTR, the attention) runs on the rank's
  edges with every channel, its weights gathered
  (``ModelGroup.call_divergent``); node features and positions enter the
  edge region through ``copy_to``.  Each reduction onto the edges' targets
  gives the complete sums of the rank's rows: over its slots in the
  fixed-degree layout, where the rank's edges are exactly its rows' slots;
  in the ragged and uniform layouts, where a node's edges may lie on two
  ranks, as partial sums of every node completed by ``reduce_scatter``
  (ops/segment.py, which also takes the softmax's max and denominator over
  the ranks).  ``proj`` then runs on the rank's rows, and the rows come
  back by ``gather`` at the node boundary.  The node-level FFNs stay TP.
  The batch keeps its whole edge arrays; the backbone takes its slice
  (``ModelGroup.edge_shard``), so evaluation and serving paths need
  nothing.
* **DP**: each data row runs its micro-batches through
  ``parallel/data_parallel.py``'s loop and one flat all-reduce, over the
  ``data`` group.

The JAX composite step calls no ``cast_params``: a model built with
``compute_dtype=bfloat16`` computes its activations in bfloat16 against the
float32 parameters (each module casts as the JAX modules do).  The port's
composite step does the same.  At M = 1 nothing is sharded and the step is
the data-parallel step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn as nn

from ..nn.attention import GraphAttention
from ..nn.partition import chunked_index, param_roles, partitionable, roles_of
from ..train.trainer import matpes_loss_grad
from .data_parallel import DataParallelStep
from .multihost import process_count, process_index

__all__ = ["ModelGroup", "CompositeMesh", "CompositeStep", "make_composite_mesh", "shard_state",
           "gather_state", "gather_named", "batch_shards", "make_composite_matpes_step",
           "EdgeShard", "edge_shard"]

# ── collectives (no autograd) ───────────────────────────────────────────────

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _all_max(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    xc = x.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(xc) for _ in range(size)]
    dist.all_gather(parts, xc, group=group)
    return torch.cat(parts, 0).movedim(0, dim)


def _own(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).clone(memory_format=torch.contiguous_format)


# ── region functions (autograd) ─────────────────────────────────────────────

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _ReduceFrom.apply(dy, ctx.g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        g.tally("all_reduce", x)
        return _all_reduce(x, g.group)

    @staticmethod
    def backward(ctx, dy):
        return _CopyTo.apply(dy, ctx.g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        g.tally("all_gather", x)
        return _all_gather(x, dim, g.group, g.size)

    @staticmethod
    def backward(ctx, dy):
        return _Scatter.apply(dy, ctx.g, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _own(x, dim, g.rank, g.size)

    @staticmethod
    def backward(ctx, dy):
        return _Gather.apply(dy, ctx.g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        g.tally("reduce_scatter", x)
        return _own(_all_reduce(x, g.group), dim, g.rank, g.size)

    @staticmethod
    def backward(ctx, dy):
        return _GatherToPartial.apply(dy, ctx.g, ctx.dim), None, None


class _GatherToPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        g.tally("all_gather", x)
        return _all_gather(x, dim, g.group, g.size)

    @staticmethod
    def backward(ctx, dy):
        return _ReduceScatter.apply(dy, ctx.g, ctx.dim), None, None


@dataclass(frozen=True)
class EdgeShard:
    """This rank's share of a batch under sequence parallelism: the
    contiguous ``edges`` of the padded edge axis, the node ``rows`` whose
    complete sums it holds, whether the layout is ``fixed``-degree (the
    edges are then exactly the rows' slots), and the ``ModelGroup`` ``mp``
    that completes the sums (ops/segment.py)."""

    edges: slice
    rows: slice
    fixed: bool
    mp: "ModelGroup"


def edge_shard(num_nodes: int, num_edges: int, mp: "ModelGroup",
               fixed: bool = False) -> EdgeShard | None:
    """The even split of ``mp``'s rank: edges [r E/M, (r+1) E/M) and node
    rows [r N/M, (r+1) N/M); None when the edge axis stays whole (M = 1, or
    M does not divide E or N)."""
    M, r = mp.size, mp.rank
    if M == 1 or num_nodes % M or num_edges % M:
        return None
    w, e = num_nodes // M, num_edges // M
    return EdgeShard(slice(r * e, (r + 1) * e), slice(r * w, (r + 1) * w), fixed, mp)


class ModelGroup:
    """This rank's place on the ``model`` axis (``size`` ranks, this one
    ``rank``, process group ``group``) and the region functions over it.
    ``sp``: the edge axis is split too.  ``counts`` / ``bytes`` tally the
    collectives the forward and backward passes launch, by kind, and the
    bytes of this rank's input to each."""

    def __init__(self, size: int, rank: int, group=None, sp: bool = False):
        self.size, self.rank, self.group, self.sp = size, rank, group, sp
        self.counts = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
                       "all_reduce_max": 0}
        self.bytes = dict.fromkeys(self.counts, 0)

    def tally(self, kind: str, x: torch.Tensor) -> None:
        self.counts[kind] += 1
        self.bytes[kind] += x.numel() * x.element_size()

    def copy_to(self, x):
        """Replicated -> used by this rank alone: identity; backward sums."""
        return _CopyTo.apply(x, self)

    def reduce_from(self, x):
        """Partial sums -> replicated: all-reduce; backward identity."""
        return _ReduceFrom.apply(x, self)

    def gather(self, x, dim: int = 0):
        """Split along ``dim`` -> replicated (concatenated in rank order)."""
        return _Gather.apply(x, self, dim)

    def scatter(self, x, dim: int = 0):
        """Replicated -> this rank's contiguous part along ``dim``."""
        return _Scatter.apply(x, self, dim)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the ranks, without autograd (for a
        detached statistic)."""
        self.tally("all_reduce_max", x)
        return _all_max(x, self.group)

    def reduce_scatter(self, x, dim: int = -1):
        """Partial sums -> this rank's contiguous part of their sum."""
        return _ReduceScatter.apply(x, self, dim % x.dim())

    def part(self, n: int) -> slice:
        """This rank's contiguous 1/size of a width ``n``."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def edge_shard(self, num_nodes: int, num_edges: int,
                   fixed: bool = False) -> EdgeShard | None:
        """Under ``sp``, this rank's ``edge_shard`` of a batch of N nodes and
        E edges; None without ``sp``."""
        return edge_shard(num_nodes, num_edges, self, fixed) if self.sp else None

    def _full_param(self, p: torch.Tensor, shard) -> torch.Tensor:
        if shard is None:
            return self.copy_to(p)
        dim, inv = shard
        full = _GatherToPartial.apply(p, self, dim)
        return full.index_select(dim, inv.to(full.device))

    def call_divergent(self, module: nn.Module, *args, **kwargs):
        """Call ``module`` on this rank's share of the work with every one of
        its parameters whole: sharded leaves gathered (backward:
        reduce-scatter), replicated leaves through ``copy_to`` (backward:
        all-reduce), so that each leaf's gradient sums the ranks' shares."""
        params = {}
        for mname, mod in module.named_modules():
            shards = mod.__dict__.get("_tp_shards", {})
            for leaf, p in mod._parameters.items():
                if p is not None:
                    params[f"{mname}.{leaf}" if mname else leaf] = self._full_param(
                        p, shards.get(leaf))
        return torch.func.functional_call(module, params, args, kwargs)


# ── mesh ────────────────────────────────────────────────────────────────────

@dataclass
class CompositeMesh:
    """A (data, model) process mesh: ``data`` rows of ``model`` ranks; this
    rank is (``data_index``, ``model_index``).  ``mp`` is its ``ModelGroup``;
    ``data_group`` the ranks of its model column (the DP all-reduce)."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: object
    mp: ModelGroup
    roles: dict | None = None   # param_roles of the whole model (shard_state)

    @property
    def sharded(self) -> bool:
        return self.model > 1

    def gather_state(self, state) -> dict:
        return gather_state(state, self)

    def load_full_state(self, state, sd: dict) -> None:
        _load_full_state(state, sd, self)


def make_composite_mesh(model_parallel: int = 1) -> CompositeMesh:
    """The (data, model) mesh of this job's processes: data = world //
    model_parallel rows; rank r is (r // M, r % M).  Creates the process
    groups (every rank must call this, in the same order)."""
    world, rank = process_count(), process_index()
    M = model_parallel
    if M < 1 or world % M:
        raise ValueError(f"{world} processes do not split into model={M} columns")
    D = world // M
    d, m = divmod(rank, M)
    model_group = data_group = None
    if dist.is_initialized() and world > 1:
        for row in range(D):
            g = dist.new_group([row * M + j for j in range(M)])
            if row == d:
                model_group = g
        for col in range(M):
            g = dist.new_group([i * M + col for i in range(D)])
            if col == m:
                data_group = g
    return CompositeMesh(D, M, d, m, data_group, ModelGroup(M, m, model_group))


# ── state ───────────────────────────────────────────────────────────────────

def _sharded_leaves(model: nn.Module, roles: dict):
    """(name, module, leaf, dim, widths) of every leaf sharded in ``roles``."""
    for mname, mod in model.named_modules():
        for leaf, (_, widths) in roles_of(mod).items():
            name = f"{mname}.{leaf}" if mname else leaf
            if roles.get(name) is not None:
                yield name, mod, leaf, roles[name], widths


def _index(n: int, widths, rank: int, size: int) -> torch.Tensor:
    return torch.as_tensor(chunked_index(n, widths, rank, size))


@torch.no_grad()
def shard_state(state, mesh: CompositeMesh) -> None:
    """Keep, in place, this rank's share of ``state`` (a whole TrainState:
    the counterpart of the JAX package's ``state_shardings``): every leaf
    that ``param_roles`` shards, its AdamW moments and its EMA; the step,
    the counters and every other leaf stay whole.  Hands the modules the
    mesh's ``ModelGroup`` (under ``sp`` the attention modules run
    unpartitioned on the rank's edges, their weights gathered).  At
    model = 1 nothing changes."""
    model, M, mp = state.model, mesh.model, mesh.mp
    roles = param_roles(model, M)
    mesh.roles = roles
    state.mesh = mesh
    if M == 1:
        return
    opt = state.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = list(_sharded_leaves(model, roles))
    for name, mod, leaf, dim, widths in leaves:
        if not partitionable(mod, M):
            raise ValueError(f"{name}: a chunk of {widths} does not split into model={M} parts")
    for name, mod, leaf, dim, widths in leaves:
        p = getattr(mod, leaf)
        n = p.shape[dim]
        idx = _index(n, widths, mp.rank, M).to(p.device)
        perm = torch.cat([_index(n, widths, r, M) for r in range(M)])
        mod.__dict__.setdefault("_tp_shards", {})[leaf] = (dim, torch.argsort(perm))
        state.ema[name] = state.ema[name].index_select(dim, idx)
        st = opt.opt.state.get(p)
        for k in ("exp_avg", "exp_avg_sq") if st else ():
            st[k] = st[k].index_select(dim, idx.to(st[k].device))
        p.data = p.data.index_select(dim, idx).contiguous()
    for mod in model.modules():
        if hasattr(mod, "mp"):
            mod.mp = mp
    if mp.sp:
        for ga in (m for m in model.modules() if isinstance(m, GraphAttention)):
            for sub in ga.modules():
                if hasattr(sub, "mp"):
                    sub.mp = None
    opt.model_group = mp
    opt.sharded = [roles[names[id(p)]] is not None for p in opt.params]


def _gather_leaf(t: torch.Tensor, mod: nn.Module, leaf: str, mp: ModelGroup) -> torch.Tensor:
    dim, inv = mod._tp_shards[leaf]
    full = _all_gather(t, dim, mp.group, mp.size)
    return full.index_select(dim, inv.to(full.device))


@torch.no_grad()
def gather_named(tensors: dict, model: nn.Module, mesh: CompositeMesh) -> dict:
    """Whole copies of a name -> shard dict (parameters, gradients, EMA):
    the sharded names gathered over the ``model`` group, the rest as they
    are.  Every rank of the group must call it."""
    out = dict(tensors)
    if mesh.model > 1:
        for name, mod, leaf, _, _ in _sharded_leaves(model, mesh.roles):
            if name in out:
                out[name] = _gather_leaf(out[name], mod, leaf, mesh.mp)
    return out


@torch.no_grad()
def gather_state(state, mesh: CompositeMesh) -> dict:
    """The whole ``TrainState.state_dict()`` of a sharded state (the
    counterpart of ``state_partition_specs``): every rank of the model
    group must call it; each gets the same dict."""
    model, opt = state.model, state.optimizer
    sd = {"model": dict(model.state_dict()), "optimizer": opt.state_dict(),
          "ema": dict(state.ema), "step": state.step}
    if mesh.model == 1:
        return sd
    adam = sd["optimizer"]["adamw"]["state"]
    # the optimizer's state_dict numbers the parameters in its groups' order
    order = [p for g in opt.opt.param_groups for p in g["params"]]
    slot = {id(p): i for i, p in enumerate(order)}
    sd["model"] = gather_named(sd["model"], model, mesh)
    sd["ema"] = gather_named(sd["ema"], model, mesh)
    for name, mod, leaf, _, _ in _sharded_leaves(model, mesh.roles):
        p = getattr(mod, leaf)
        st = adam.get(slot[id(p)])
        if st is not None:
            st = adam[slot[id(p)]] = dict(st)
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = _gather_leaf(st[k], mod, leaf, mesh.mp)
    return sd


@torch.no_grad()
def _load_full_state(state, sd: dict, mesh: CompositeMesh) -> None:
    """Load a whole state dict (a checkpoint) into a sharded ``state``:
    this rank's share of each sharded leaf (resuming re-shards)."""
    model, opt, mp = state.model, state.optimizer, mesh.mp
    order = [p for g in opt.opt.param_groups for p in g["params"]]
    slot = {id(p): i for i, p in enumerate(order)}
    sd = {"model": dict(sd["model"]), "optimizer": sd["optimizer"], "ema": dict(sd["ema"]),
          "step": sd["step"]}
    adam = dict(sd["optimizer"]["adamw"]["state"])
    sd["optimizer"] = {**sd["optimizer"], "adamw": {**sd["optimizer"]["adamw"], "state": adam}}
    for name, mod, leaf, dim, widths in _sharded_leaves(model, mesh.roles):
        p = getattr(mod, leaf)
        n = sd["model"][name].shape[dim]
        idx = _index(n, widths, mp.rank, mp.size)
        sd["model"][name] = sd["model"][name].index_select(dim, idx)
        sd["ema"][name] = sd["ema"][name].index_select(dim, idx)
        st = adam.get(slot[id(p)])
        if st is not None:
            adam[slot[id(p)]] = {**st, **{k: st[k].index_select(dim, idx)
                                          for k in ("exp_avg", "exp_avg_sq")}}
    model.load_state_dict(sd["model"])
    opt.load_state_dict(sd["optimizer"])
    for k, v in sd["ema"].items():
        state.ema[k].copy_(v)
    state.step = int(sd["step"])


# ── batches ─────────────────────────────────────────────────────────────────

def batch_shards(stacked: dict, mesh: CompositeMesh, sp: bool = False):
    """This rank's part of a stacked micro-batch dict [data, ...] (the
    counterpart of ``batch_shardings``): data row d takes micro-batches
    [d n, (d+1) n), n = data / rows; every rank of the row takes the same.
    Returns (local stacked, edge shard): with ``sp`` the rank's
    ``edge_shard`` (where M divides E_pad and N_pad), whose edges the
    backbone slices out of the whole edge arrays it is given; None when the
    edge axis stays whole."""
    n_total = next(iter(stacked.values())).shape[0]
    if n_total % mesh.data:
        raise ValueError(f"{n_total} micro-batches do not split over {mesh.data} data rows")
    n = n_total // mesh.data
    local = {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in stacked.items()}
    shard = None
    if sp:
        N, E = stacked["atomic_numbers"].shape[1], stacked["edge_src"].shape[1]
        shard = edge_shard(N, E, mesh.mp)
    return local, shard


# ── the step ────────────────────────────────────────────────────────────────

class CompositeStep(DataParallelStep):
    """``DataParallelStep`` over the ``data`` group whose ``reduce`` also
    averages, over the ``model`` group, the replicated leaves' gradients
    and the loss and metrics.  Each rank of a row computes those whole, and
    the average keeps the replicated masters identical on every rank of the
    row whatever order a rank's sums take."""

    def __init__(self, state, loss_grad, data: int, ema_decay: float, mesh: CompositeMesh):
        super().__init__(state, loss_grad, data, ema_decay, group=mesh.data_group,
                         group_size=mesh.data)
        self.mp = mesh.mp if mesh.model > 1 else None
        sharded = set(n for n, d in (mesh.roles or {}).items() if d is not None)
        self.replicated = [n not in sharded for n in self.names]
        self.mask: torch.Tensor | None = None

    def reduce(self, flat: torch.Tensor) -> torch.Tensor:
        flat = super().reduce(flat)
        if self.mp is None:
            return flat
        if self.mask is None:
            self.mask = torch.cat(
                [torch.full((n,), r, dtype=torch.bool)
                 for n, r in zip(self.sizes, self.replicated)]
                + [torch.ones(flat.numel() - self.n_grad, dtype=torch.bool)]).to(flat.device)
        part = flat[self.mask]
        dist.all_reduce(part, group=self.mp.group)
        flat[self.mask] = part.div_(self.mp.size)
        return flat


def make_composite_matpes_step(state, mesh: CompositeMesh, data: int, w_energy: float = 1.0,
                               w_force: float = 1.0, w_stress: float = 0.0, sp: bool = False,
                               ema_decay: float = 0.999,
                               generator: torch.Generator | None = None,
                               inner_ckpt: bool = False) -> Callable:
    """Composite DP x TP x EP (x SP) MatPES train step (the JAX package's
    ``make_composite_matpes_step``): ``step(stacked) -> (loss, metrics)``,
    ``stacked`` this data row's micro-batches (``batch_shards``).  The loss
    is the mean over the ``data`` micro-batches of the energy + force (+
    per-graph stress when ``w_stress > 0``) loss; one guarded AdamW update
    (the gradient norm over the shards), then the EMA.  ``state`` is a whole
    TrainState (the step shards it with ``shard_state``); every rank of a
    data row must hold the same weights and draw the same dropout masks
    (``generator`` seeded from the data index).  The parameters keep their
    float32 type in the forward (no ``cast_params``, as in JAX).
    ``inner_ckpt`` as ``train/trainer.py:make_matpes_train_step``: every
    rank recomputes the same region collectives in the same order."""
    mesh.mp.sp = sp
    shard_state(state, mesh)
    loss_grad = matpes_loss_grad(state, w_energy, w_force, w_stress, generator,
                                 cast=False, inner_ckpt=inner_ckpt)
    return CompositeStep(state, loss_grad, data, ema_decay, mesh)
