"""DP x GPipe pipeline parallelism over the transformer block stack.

Port of the JAX package's parallel/pipeline.py.  There the step is one SPMD
program under ``shard_map``: ``ppermute`` moves activations stage to stage
and ``psum`` replicates the output, and their transposes run the reverse
pipeline.  Here every rank is a process and the collectives are written
out; the numbers are those of the unsharded step.

* **Mesh.** Ranks are laid out as the JAX package lays out devices,
  ``reshape(data, pipe)``: rank = d P + p.  ``make_dp_pipe_mesh`` makes one
  process group per data row (``pipe``: the P stages of row d) and one per
  stage column (``data``).
* **Schedule** (``pipeline_apply``, the JAX schedule): with M micro-batches
  and P stages, T = M + P - 1 ticks.  At every tick every rank shifts its
  last output one stage on around the ring, stage 0 takes micro-batch t
  instead (zeros once the micro-batches are used up), every stage applies
  its L/P blocks, and stage P-1 keeps the finished micro-batch t - (P - 1).
  The kept outputs are summed over the stages (only stage P-1's are not
  zero), which replicates them.  Every rank runs every tick and picks its
  role with ``torch.where`` on its stage index, never a Python branch: every
  rank then builds the same graph, so its backward and the force loss's
  double backward meet the collectives in the same order on every rank.
  Each stage runs its blocks M + P - 1 times, P - 1 of them on bubble
  states (zeros, or what a stage made of zeros), which every block keeps
  finite.
* **Collectives** (autograd functions; each backward calls another through
  ``.apply``, so the grad-of-grad of the force loss crosses them again, as
  parallel/sharding.py's region functions do): the ring shift is an
  ``all_gather`` of this rank's state (its leaves packed per dtype) from
  which a rank keeps its predecessor's; its backward is the inverse shift.
  Stage 0's feed enters through ``copy_to`` (identity; backward all-reduce:
  the pre-stack, computed alike on every rank, gets its whole gradient on
  every rank), and the output leaves through ``reduce_from`` (all-reduce;
  backward identity).  Gloo takes no point-to-point send of CUDA tensors,
  hence the all-gather; ``torch.distributed.nn.functional.all_reduce`` is
  not used (its backward all-reduces again, multiplying the replicated
  post-stack's gradient by P).
* **State** (``pipeline_shard_state``, the counterpart of
  ``pipeline_state_shardings``): a stage keeps its L/P blocks (their
  masters, AdamW moments and EMA) and every other leaf whole;
  ``pipeline_gather_state`` gives every rank of a data row the whole
  ``TrainState.state_dict()`` of a one-process run (rank 0 writes it), and
  loading a whole one keeps the stage's share.
* **The step** (``make_pipeline_matpes_step``): per data row, the
  pre-stack of each local micro-batch (``stack_capture``), the blocks
  through ``pipeline_apply``, the heads (``stack_override``), forces =
  -dE/dpos through the whole pipeline (kept for the loss's backward), the
  mean MatPES loss over the micro-batches (w_stress 0), then the data
  rows' one flat all-reduce (parallel/data_parallel.py), the replicated
  leaves' gradients averaged over the stages (their copies differ in the
  last bits on the card), the guarded AdamW (its global norm counts each
  stage's blocks once and each replicated leaf once) and the EMA.  Unlike
  the composite step, and as the JAX pipeline step does, a model that
  computes in bfloat16 is called with bfloat16 copies of its masters
  (``cast_params``).  Dropout draws from each rank's own generator.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.backbone import StackBroadcast
from ..train.trainer import cast_params, matpes_loss
from ..utils.precision import full_f32_products
from .data_parallel import DataParallelStep
from .multihost import process_count, process_index
from .sharding import CompositeStep, ModelGroup

__all__ = ["StageGroup", "PipeMesh", "make_dp_pipe_mesh",
           "pipeline_apply", "pipeline_shard_state", "pipeline_gather_state",
           "pipeline_energy_forces", "PipelineStep", "make_pipeline_matpes_step"]

# ── the ring shift ──────────────────────────────────────────────────────────

def _ring(xs: Sequence[torch.Tensor], step: int, g: "StageGroup") -> list[torch.Tensor]:
    """Every rank's ``xs`` moved ``step`` stages on around the ring: this
    rank gets rank (r - step)'s.  One all-gather per dtype."""
    out: list[torch.Tensor | None] = [None] * len(xs)
    src = (g.rank - step) % g.size
    for dtype in sorted({x.dtype for x in xs}, key=str):
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        flat = torch.cat([xs[i].reshape(-1) for i in idx])
        if dtype == torch.bool:
            flat = flat.view(torch.uint8)
        parts = [torch.empty_like(flat) for _ in range(g.size)]
        dist.all_gather(parts, flat, group=g.group)
        got = parts[src].view(torch.bool) if dtype == torch.bool else parts[src]
        for i, v in zip(idx, got.split([xs[i].numel() for i in idx])):
            out[i] = v.view_as(xs[i])
        g.tally("shift", flat)
    return out


class _Shift(torch.autograd.Function):
    """Ring shift by ``step`` stages; backward: the shift by ``-step`` of the
    leaves that carry a gradient."""

    @staticmethod
    def forward(ctx, g, step, *xs):
        ctx.g, ctx.step = g, step
        ctx.diff = tuple(ctx.needs_input_grad[2:])
        out = _ring(xs, step, g)
        ctx.mark_non_differentiable(*[o for o, d in zip(out, ctx.diff) if not d])
        return tuple(out)

    @staticmethod
    def backward(ctx, *dys):
        live = [dy for dy, d in zip(dys, ctx.diff) if d]
        back = iter(_Shift.apply(ctx.g, -ctx.step, *live))
        return (None, None, *[next(back) if d else None for d in ctx.diff])


class StageGroup(ModelGroup):
    """This rank's place on the ``pipe`` axis (``size`` stages, this one
    ``rank``, process group ``group``): the region functions of
    ``ModelGroup`` (``copy_to``, ``reduce_from``) and the ring ``shift``.
    ``counts`` / ``bytes`` tally the collectives by kind (``shift``: the
    bytes this rank puts into each all-gather), ``ticks`` and ``bubble``
    the schedule's ticks and this stage's bubble ticks, ``tick_bytes`` the
    bytes of the last state shifted forward."""

    def __init__(self, size: int, rank: int, group=None):
        super().__init__(size, rank, group)
        self.counts["shift"] = self.bytes["shift"] = 0
        self.ticks = self.bubble = self.tick_bytes = 0

    def shift(self, state: tuple) -> tuple:
        """Every rank's ``state`` (a tuple of tensors or None) one stage on:
        this rank gets its predecessor's (stage 0 stage P-1's)."""
        live = [i for i, x in enumerate(state) if x is not None]
        self.tick_bytes = sum(state[i].numel() * state[i].element_size() for i in live)
        moved = _Shift.apply(self, 1, *[state[i] for i in live]) if live else ()
        out = list(state)
        for i, v in zip(live, moved):
            out[i] = v
        return tuple(out)


# ── mesh ────────────────────────────────────────────────────────────────────

@dataclass
class PipeMesh:
    """A (data, pipe) process mesh: ``data`` rows of ``pipe`` stages; this
    rank is (``data_index``, ``pipe_index``).  ``stages`` is its
    ``StageGroup``; ``data_group`` the ranks of its stage column (the DP
    all-reduce).  ``stage``: the block indices this rank holds
    (``pipeline_shard_state``); ``layout``: the names and optimizer groups
    of the whole state, for gathering it."""

    data: int
    pipe: int
    data_index: int
    pipe_index: int
    data_group: object
    stages: StageGroup
    stage: range | None = None
    layout: dict = field(default_factory=dict)

    @property
    def sharded(self) -> bool:
        return self.pipe > 1

    def gather_state(self, state) -> dict:
        return pipeline_gather_state(state, self)

    def load_full_state(self, state, sd: dict) -> None:
        _load_full_state(state, sd, self)


def make_dp_pipe_mesh(data: int, pipe: int) -> PipeMesh:
    """The (data, pipe) mesh of this job's data x pipe processes: rank r is
    (r // pipe, r % pipe).  Creates the process groups (every rank must call
    this, in the same order)."""
    world, rank = process_count(), process_index()
    if data < 1 or pipe < 1 or data * pipe != world:
        raise ValueError(f"need {data * pipe} processes for data={data} pipe={pipe}, "
                         f"have {world}")
    d, p = divmod(rank, pipe)
    pipe_group = data_group = None
    if dist.is_initialized() and world > 1:
        for row in range(data):
            g = dist.new_group([row * pipe + j for j in range(pipe)])
            if row == d:
                pipe_group = g
        for col in range(pipe):
            g = dist.new_group([i * pipe + col for i in range(data)])
            if col == p:
                data_group = g
    return PipeMesh(data, pipe, d, p, data_group, StageGroup(pipe, p, pipe_group))


# ── the schedule ────────────────────────────────────────────────────────────

def _where(pred: torch.Tensor, a: tuple, b: tuple) -> tuple:
    return tuple(None if x is None else torch.where(pred, x, y) for x, y in zip(a, b))


def pipeline_apply(body_fn: Callable, stage_blocks: Sequence, micro_states: Sequence[tuple],
                   mesh: PipeMesh, keep: Sequence[int] | None = None) -> list[tuple]:
    """Run ``micro_states`` through the whole block stack on the P-stage
    pipeline of this rank's data row.

    body_fn(block, state) -> state
        one block (or a run of blocks); ``block`` an item of
        ``stage_blocks``.
    stage_blocks
        this stage's blocks, in order (its L/P of the stack).
    micro_states
        this data row's M >= 1 micro-batches, each a tuple of tensors (or
        None), the same on every stage of the row.
    keep
        the leaves of the output states to return (default: all); the
        others are None.

    Returns the M output states, replicated over the stages.
    """
    g = mesh.stages
    P, M = g.size, len(micro_states)
    keep = range(len(micro_states[0])) if keep is None else keep
    device = next(x for x in micro_states[0] if x is not None).device
    first = torch.tensor(g.rank == 0, device=device)
    last = torch.tensor(g.rank == P - 1, device=device)
    zeros = tuple(None if x is None else torch.zeros_like(x) for x in micro_states[0])
    prev, outs = zeros, []
    for t in range(M + P - 1):
        incoming = g.shift(prev)
        feed = (tuple(None if x is None else g.copy_to(x) for x in micro_states[t])
                if t < M else zeros)
        out = _where(first, feed, incoming)
        for block in stage_blocks:
            out = body_fn(block, out)
        if t >= P - 1:    # stage P-1 finished micro-batch t - (P - 1)
            outs.append(_where(last, out, zeros))
        prev = out
        g.ticks += 1
        g.bubble += not 0 <= t - g.rank < M
    return [tuple(g.reduce_from(s[i]) if i in keep and s[i] is not None else None
                  for i in range(len(s))) for s in outs]


# ── state ───────────────────────────────────────────────────────────────────

def _stage_of(name: str, stage: range) -> bool:
    """The parameter ``name`` is a replicated leaf or one of the stage's blocks."""
    parts = name.split(".")
    if parts[:2] != ["backbone", "blocks"]:
        return True
    return int(parts[2]) in stage


@torch.no_grad()
def pipeline_shard_state(state, mesh: PipeMesh) -> None:
    """Keep, in place, this stage's share of ``state`` (a whole
    TrainState): its L/P blocks (the others become ``nn.Identity``), their
    AdamW moments and EMA, and every other leaf whole; hands the optimizer
    the ``pipe`` group for its global norm."""
    model, opt = state.model, state.optimizer
    L, P = len(model.backbone.blocks), mesh.pipe
    if L % P:
        raise ValueError(f"num_layers {L} not divisible by pipe={P}")
    n = L // P
    mesh.stage = range(mesh.pipe_index * n, (mesh.pipe_index + 1) * n)
    names = {id(p): name for name, p in model.named_parameters()}
    mesh.layout = dict(
        model=list(model.state_dict()),
        groups=[({k: v for k, v in grp.items() if k != "params"},
                 [names[id(p)] for p in grp["params"]]) for grp in opt.opt.param_groups])
    for i in range(L):
        if i not in mesh.stage:
            model.backbone.blocks[i] = nn.Identity()
    kept = {id(p) for p in model.parameters()}
    opt.params = [p for p in opt.params if id(p) in kept]
    for grp in opt.opt.param_groups:
        grp["params"] = [p for p in grp["params"] if id(p) in kept]
    for p in [p for p in opt.opt.state if id(p) not in kept]:
        del opt.opt.state[p]
    for name in [k for k in state.ema if not _stage_of(k, mesh.stage)]:
        del state.ema[name]
    opt.model_group = mesh.stages
    opt.sharded = [names[id(p)].startswith("backbone.blocks.") for p in opt.params]
    state.mesh = mesh


def _host(x):
    return x.detach().to("cpu", copy=True) if torch.is_tensor(x) else x


@torch.no_grad()
def pipeline_gather_state(state, mesh: PipeMesh) -> dict:
    """The whole ``TrainState.state_dict()`` of a stage-sharded state, in a
    one-process run's layout, on the host: every rank of the data row must
    call it; each gets the same dict."""
    model, opt = state.model, state.optimizer
    names = {id(p): n for n, p in model.named_parameters()}
    mine = dict(model={k: _host(v) for k, v in model.state_dict().items()},
                ema={k: _host(v) for k, v in state.ema.items()},
                adam={names[id(p)]: {k: _host(v) for k, v in st.items()}
                      for p, st in opt.opt.state.items()})
    parts = [None] * mesh.pipe
    dist.all_gather_object(parts, mine, group=mesh.stages.group)
    merged = {key: {k: v for part in parts for k, v in part[key].items()}
              for key in ("model", "ema", "adam")}
    order = mesh.layout["model"]
    groups, adam, slot = [], {}, 0
    for hyper, gnames in mesh.layout["groups"]:
        groups.append({**hyper, "params": list(range(slot, slot + len(gnames)))})
        for i, n in enumerate(gnames):
            if n in merged["adam"]:
                adam[slot + i] = merged["adam"][n]
        slot += len(gnames)
    own = opt.state_dict()
    return {"model": {k: merged["model"][k] for k in order},
            "optimizer": {**own, "adamw": {"state": adam, "param_groups": groups}},
            "ema": {k: merged["ema"][k] for k in order if k in merged["ema"]},
            "step": state.step}


@torch.no_grad()
def _load_full_state(state, sd: dict, mesh: PipeMesh) -> None:
    """Load a whole state dict (a checkpoint) into a stage-sharded
    ``state``: the stage's share of it (resuming re-shards)."""
    model, opt = state.model, state.optimizer
    own = set(model.state_dict())
    model.load_state_dict({k: v for k, v in sd["model"].items() if k in own})
    whole = [n for _, gnames in mesh.layout["groups"] for n in gnames]
    by_name = {whole[i]: st for i, st in sd["optimizer"]["adamw"]["state"].items()}
    names = {id(p): n for n, p in model.named_parameters()}
    local = opt.opt.state_dict()
    slots = [names[id(p)] for grp in opt.opt.param_groups for p in grp["params"]]
    adamw = {"state": {i: by_name[n] for i, n in enumerate(slots) if n in by_name},
             "param_groups": [{**whole, "params": grp["params"]} for whole, grp in
                              zip(sd["optimizer"]["adamw"]["param_groups"],
                                  local["param_groups"])]}
    opt.load_state_dict({**sd["optimizer"], "adamw": adamw})
    for k, v in state.ema.items():
        v.copy_(sd["ema"][k])
    state.step = int(sd["step"])


# ── the MatPES step ─────────────────────────────────────────────────────────

def _flatten(carry: tuple, bc: StackBroadcast) -> tuple[tuple, tuple]:
    """(leaves, spec) of a (carry, broadcast) state: the carry, the
    broadcast's tensors and the Wigner tables' as one tuple."""
    w = bc.wigner
    wn = [n for n, v in vars(w).items() if torch.is_tensor(v)]
    leaves = (*carry, *bc[:5], *(getattr(w, n) for n in wn), *bc[6:9])
    return leaves, (w, wn, bc.blocks)


def _unflatten(leaves: tuple, spec: tuple) -> tuple[tuple, StackBroadcast]:
    w0, wn, blocks = spec
    w = copy.copy(w0)
    w.__dict__.update(zip(wn, leaves[8:8 + len(wn)]))
    if "_tables" in vars(w):   # the factored tables are per Wigner object
        w._tables = {}
    return tuple(leaves[:3]), StackBroadcast(*leaves[3:8], w, *leaves[8 + len(wn):], blocks)


def pipeline_energy_forces(model: nn.Module, batches: Sequence[dict], mesh: PipeMesh,
                           params: dict | None = None, create_graph: bool = False,
                           generator: torch.Generator | None = None) -> list[dict]:
    """Energy outputs and forces (-dE_total/d pos, masked) of this data
    row's micro-batches ``batches`` through the pipeline: the counterpart of
    ``models/matpes.py:matpes_energy_forces`` on a stage-sharded model.
    Every rank of the row must call it with the same batches; each gets the
    whole results.  ``params``: a name -> tensor mapping to call the model
    with (the bfloat16 copies, the EMA); ``create_graph`` keeps the graph
    of the forces for a loss's backward."""
    if params is None:
        params = dict(model.named_parameters())
    bb_params = {n[len("backbone."):]: v for n, v in params.items()
                 if n.startswith("backbone.blocks.")}
    pos = [b["pos"].detach().requires_grad_(True) for b in batches]
    with torch.enable_grad():
        states = []
        for b, ps in zip(batches, pos):
            carry, bc = torch.func.functional_call(
                model, params, (b,), dict(pos=ps, generator=generator, stack_capture=True))
            leaves, spec = _flatten(carry, bc)
            states.append(leaves)
        num_graphs = batches[0]["cell"].shape[0]

        def body(stage: range, leaves):   # the stage's blocks, one after another
            carry, bc = _unflatten(leaves, spec)
            carry = model.backbone.run_blocks(carry, bc, num_graphs, stage.start, stage.stop,
                                              generator, params=bb_params)
            return (*carry, *leaves[3:])

        done = pipeline_apply(body, [mesh.stage], states, mesh, keep=(0,))
        outs = [torch.func.functional_call(model, params, (b,),
                                           dict(pos=ps, stack_override=(d[0], None, None)))
                for b, ps, d in zip(batches, pos, done)]
        total = sum(o["energy_total"].sum() for o in outs)
        dpos = torch.autograd.grad(total, pos, create_graph=create_graph)
    results = []
    for o, d, b in zip(outs, dpos, batches):
        r = dict(o) if create_graph else {k: v.detach() for k, v in o.items()}
        r["forces"] = -d * b["node_mask"][:, None].to(d.dtype)
        results.append(r)
    return results


class PipelineStep(CompositeStep):
    """``step(stacked) -> (loss, metrics)``, ``stacked`` this data row's
    micro-batches [M, ...]: ``DataParallelStep`` over the ``data`` group
    whose ``accumulate`` runs all M micro-batches through one pipeline
    (the sums of their gradients and metrics) and whose ``reduce`` also
    averages the replicated leaves' gradients and the metrics over the
    stages (``CompositeStep.reduce``)."""

    def __init__(self, state, loss_grad, data: int, ema_decay: float, mesh: PipeMesh):
        DataParallelStep.__init__(self, state, loss_grad, data, ema_decay,
                                  group=mesh.data_group, group_size=mesh.data)
        self.mp = mesh.stages if mesh.pipe > 1 else None
        self.replicated = [not n.startswith("backbone.blocks.") for n in self.names]
        self.mask: torch.Tensor | None = None

    def accumulate(self, stacked: dict) -> torch.Tensor:
        n = next(iter(stacked.values())).shape[0]
        if n != self.n_local:
            raise ValueError(f"{n} micro-batches given, {self.n_local} expected on each of "
                             f"{self.world} data rows (data={self.data})")
        self._add(0, *self.loss_grad(stacked))
        return self.flat


def make_pipeline_matpes_step(state, mesh: PipeMesh, data: int, w_energy: float = 1.0,
                              w_force: float = 1.0, ema_decay: float = 0.999,
                              generator: torch.Generator | None = None) -> PipelineStep:
    """DP x GPipe MatPES force-training step (the JAX package's
    ``make_pipeline_matpes_step``): ``step(stacked) -> (loss, metrics)``,
    ``stacked`` this data row's ``data / mesh.data`` micro-batches.  The
    loss is the mean over the ``data`` micro-batches of the energy + force
    loss (w_stress 0); one guarded AdamW update, then the EMA.  ``state``
    is a whole TrainState, the same on every rank (the step shards it with
    ``pipeline_shard_state``); ``generator`` draws this rank's dropout
    masks.  A model computing in bfloat16 runs on bfloat16 copies of the
    masters (``cast_params``, as in the JAX pipeline step)."""
    pipeline_shard_state(state, mesh)
    model = state.model
    cdt = model.backbone.compute_dtype

    def loss_grad(stacked: dict):
        model.train()
        n = next(iter(stacked.values())).shape[0]
        batches = [{k: v[i] for k, v in stacked.items()} for i in range(n)]
        with full_f32_products():
            model.zero_grad(set_to_none=True)
            params = cast_params(model, cdt) if cdt != torch.float32 else None
            outs = pipeline_energy_forces(model, batches, mesh, params, create_graph=True,
                                          generator=generator)
            loss, metrics = 0.0, {}
            for o, b in zip(outs, batches):
                li, mi = matpes_loss(o, b, w_energy, w_force, 0.0)
                loss = loss + li
                metrics = {k: metrics.get(k, 0.0) + v for k, v in mi.items()}
            loss.backward()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    return PipelineStep(state, loss_grad, data, ema_decay, mesh)
