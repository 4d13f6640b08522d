"""Worker processes of the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_native.py,
tests/test_torch_sharding.py, tests/test_torch_composite.py,
tests/test_torch_composite_cli.py).

This module imports the port, torch and numpy only, never JAX: spawned
children import it afresh (tests/conftest.py, which imports JAX, is not
imported in them).  Every join has a timeout, so a hung collective fails
the test instead of holding the run.
"""

import multiprocessing as mp
import os
import socket
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import native
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.oc20 import (
    EquiformerV2OC20,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.qm9 import (
    EquiformerV2QM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.ops import segment
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import data_parallel
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import multihost
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import sharding
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import train_matpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    create_train_state,
    make_matpes_train_step,
)

MODELS = {"qm9": EquiformerV2QM9, "oc20": EquiformerV2OC20, "matpes": EquiformerV2MatPES}
DP_STEPS = {"qm9": data_parallel.make_qm9_dp_step, "oc20": data_parallel.make_oc20_dp_step,
            "matpes": data_parallel.make_matpes_dp_step}
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(target, nprocs: int, *args) -> list:
    """Start ``target(rank, *args)`` in ``nprocs`` spawned processes."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(nprocs)]
    for p in procs:
        p.start()
    return procs


def join(procs: list, timeout: float = TIMEOUT_S) -> list[int]:
    """The exit codes of ``procs``, after killing any still running at
    ``timeout``."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    codes = []
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
        codes.append(p.exitcode)
    return codes


def spawn(target, nprocs: int, *args, timeout: float = TIMEOUT_S) -> list[int]:
    """Run ``target(rank, *args)`` in ``nprocs`` spawned processes; returns
    their exit codes, after killing any still running at ``timeout``."""
    return join(start(target, nprocs, *args), timeout)


def new_state(case: dict):
    """The case's model (its weights loaded) and a guarded AdamW at a
    constant learning rate."""
    model = MODELS[case["kind"]](**case["cfg"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in case["weights"].items()})
    opt = GuardedAdamW(model.named_parameters(), lambda step: case["lr"], case["wd"], 1.0)
    return create_train_state(model, opt)


def run_case(case: dict, micro: list[int]) -> dict:
    """One data-parallel step on the case's micro-batches ``micro`` (on this
    rank, or all of them in one process without a process group): the loss,
    metrics, averaged gradients, parameters and EMA after the step."""
    state = new_state(case)
    data = len(micro) * multihost.process_count()
    step = DP_STEPS[case["kind"]](state, data, **case["step_kw"])
    stacked = data_parallel.stack_microbatches(
        [tgraph.as_tensors(case["batches"][i], "cpu") for i in micro])
    loss, metrics = step(stacked)
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items() if k != "lr"},
                grads={k: v.clone() for k, v in step.mean_grads().items()},
                params={k: p.detach().clone() for k, p in state.model.named_parameters()},
                ema={k: v.clone() for k, v in state.ema.items()})


def dp_worker(rank: int, world: int, port: int, out_dir: str, cases: dict,
              threads: int) -> None:
    """Rank ``rank`` of ``world`` over gloo: every case's step on the
    case's micro-batch ``rank``; the results go to ``out_dir/rank<r>.pt``."""
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    if not multihost.initialize_from_env(device="cpu", verbose=False):
        raise RuntimeError("no process group")
    try:
        out = {name: run_case(case, [rank]) for name, case in cases.items()}
        out["backend"] = dist.get_backend()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def build_worker(rank: int, build_dir: str, barrier, pos: np.ndarray) -> None:
    """Build the neighbour-list library into ``build_dir`` at the same moment
    as the other workers, then use it; the edges go to ``build<r>.npz``."""
    native.BUILD_DIR = Path(build_dir)
    barrier.wait(60)
    src, dst, shift = native.neighbor_list_native(pos, None, False, 3.0, None)
    np.savez(Path(build_dir) / f"build{rank}.npz", src=src, dst=dst, shift=shift)


def _join_group(rank: int, world: int, port: int, threads: int) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    if not multihost.initialize_from_env(device="cpu", verbose=False):
        raise RuntimeError("no process group")


def composite_step(case: dict) -> dict:
    """One composite step of ``case`` on this rank (``case["model"]`` model
    ranks, ``case["sp"]``, micro-batches ``case["batches"]``): the loss,
    metrics, and the gathered gradients, parameters and EMA after it."""
    state = new_state(case)
    model = state.model
    mesh = sharding.make_composite_mesh(case["model"])
    gen = torch.Generator().manual_seed(data_parallel.rank_seed(case["seed"], mesh.data_index))
    data = len(case["batches"])
    step = sharding.make_composite_matpes_step(state, mesh, data, sp=case["sp"], generator=gen,
                                               **case["step_kw"])
    stacked = data_parallel.stack_microbatches(
        [tgraph.as_tensors(b, "cpu") for b in case["batches"]])
    local, _ = sharding.batch_shards(stacked, mesh, case["sp"])
    loss, metrics = step(local)
    params = {k: p.detach() for k, p in model.named_parameters()}
    return dict(loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items() if k != "lr"},
                grads=sharding.gather_named(step.mean_grads(), model, mesh),
                params=sharding.gather_named(params, model, mesh),
                ema=sharding.gather_named(state.ema, model, mesh),
                collectives=dict(mesh.mp.counts))


def shard_gather_roundtrip(case: dict) -> dict:
    """A whole state after one local step (so that the AdamW moments
    exist), sharded over the model group and gathered back; and the same
    after a whole state is loaded into the sharded one."""
    state = new_state(case)
    make_matpes_train_step(state)(tgraph.as_tensors(case["batches"][0], "cpu"))
    whole = {k: v for k, v in state.state_dict().items()}
    whole = torch.utils._pytree.tree_map(
        lambda t: t.clone() if torch.is_tensor(t) else t, whole)
    mesh = sharding.make_composite_mesh(case["model"])
    sharding.shard_state(state, mesh)
    shapes = {k: tuple(p.shape) for k, p in state.model.named_parameters()}
    first = state.state_dict()
    state.load_state_dict(whole)
    return dict(whole=whole, gathered=first, reloaded=state.state_dict(), shard_shapes=shapes)


def region_checks(rank: int, size: int, group) -> dict:
    """The region functions in a small Megatron pair against the same math
    in this process: f(x) = col / row pair closed by ``reduce_from``, by
    ``reduce_scatter`` + ``gather``, and a ``scatter`` / ``gather`` row
    split; the forward, the gradient of x (a force-like derivative, kept
    for a second differentiation), and the gradients of a loss of both
    (grad-of-grad) by x and the weights.  Returns the max relative errors."""
    mp = sharding.ModelGroup(size, rank, group)
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(6, 4, generator=g, dtype=torch.float64)
    w1 = torch.randn(4, 8, generator=g, dtype=torch.float64)
    w2 = torch.randn(8, 4, generator=g, dtype=torch.float64)
    cols = mp.part(8)

    def run(kind: str, sharded: bool):
        x = x0.clone().requires_grad_(True)
        a = w1.clone().requires_grad_(True)
        b = w2.clone().requires_grad_(True)
        if not sharded:
            y = torch.tanh(x @ a) @ b
            y = y + torch.sin(x) if kind == "scatter" else y
        elif kind == "scatter":
            y = mp.reduce_from(torch.tanh(mp.copy_to(x) @ a[:, cols]) @ b[cols])
            y = y + mp.gather(torch.sin(mp.scatter(x, 0)), 0)
        else:
            part = torch.tanh(mp.copy_to(x) @ a[:, cols]) @ b[cols]
            y = (mp.reduce_from(part) if kind == "reduce_from"
                 else mp.gather(mp.reduce_scatter(part, -1), -1))
        (dx,) = torch.autograd.grad((y ** 3).sum(), x, create_graph=True)
        loss = (dx * dx).sum() + (y * y).sum()
        loss.backward()
        return [y.detach(), dx.detach(), x.grad, a.grad, b.grad]

    out = {}
    for kind in ("reduce_from", "reduce_scatter", "scatter"):
        want, got = run(kind, False), run(kind, True)
        # a rank's weight gradient covers its own columns / rows: sum them
        got[3] = mp.reduce_from(got[3])
        got[4] = mp.reduce_from(got[4])
        out[kind] = max(float((u - v).abs().max() / v.abs().max()) for u, v in zip(got, want))
    return out


def composite_worker(rank: int, world: int, port: int, out_dir: str, cases: dict,
                     threads: int, checks: bool) -> None:
    """Rank ``rank`` of ``world`` over gloo: every case's composite step,
    and with ``checks`` the region functions and the shard / gather round
    trip at model = world; each rank's results go to ``out_dir/rank<r>.pt``."""
    _join_group(rank, world, port, threads)
    try:
        out = {name: composite_step(case) for name, case in cases.items()}
        if checks:
            out["regions"] = region_checks(rank, world, None)
            out["sp_regions"] = sp_region_checks(rank, world, None)
            out["roundtrip"] = shard_gather_roundtrip(
                dict(next(iter(cases.values())), model=world))
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def cli_worker(rank: int, world: int, port: int, run_dir: str, mesh: str, overrides: dict,
               threads: int) -> None:
    """The MatPES CLI under ``--multihost --mesh mesh`` on rank ``rank``: one
    epoch, then a second resumed from the first's checkpoint."""
    _join_group(rank, world, port, threads)
    argv = ["--config", "synthetic", "--device", "cpu", "--multihost", "--mesh", mesh]
    try:
        cfg = dict(overrides, run_dir=run_dir)
        state = train_matpes.main(argv, dict(cfg, epochs=1))
        steps = [state.step]
        state = train_matpes.main(argv + ["--checkpoint", "ckpt_epoch_00000"],
                                  dict(cfg, epochs=2))
        steps.append(state.step)
        if rank == 0:
            torch.save({"steps": steps}, Path(run_dir) / "steps.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def sp_region_checks(rank: int, size: int, group) -> dict:
    """The ragged layout's sequence-parallel reductions against the same
    math in this process: unsorted target ids over an edge axis split
    evenly over the ranks (so nodes straddle the split), some edges masked,
    float64 inputs.  "sums": a sum and a mean onto the targets
    (``reduce_scatter`` onto the rank's rows, then ``gather``); "softmax":
    the segment softmax (max and denominator over the ranks; its statistics
    in float32, as in one process) weighting a sum.  The forward, the
    gradient of the logits kept for a second differentiation, and the
    gradients of a loss of both by the logits and the values
    (grad-of-grad).  Returns the max relative errors by kind, and the
    straddling nodes."""
    mp = sharding.ModelGroup(size, rank, group, sp=True)
    g = torch.Generator().manual_seed(1)
    N, E, H = 6, 24, 2
    ids = torch.randint(0, N, (E,), generator=g)
    mask = torch.rand(E, generator=g) > 0.2
    lg0 = torch.randn(E, H, generator=g, dtype=torch.float64)
    v0 = torch.randn(E, H, 3, generator=g, dtype=torch.float64)
    w = torch.randn(N, H, 3, generator=g, dtype=torch.float64)
    shard = sharding.edge_shard(N, E, mp)

    def run(kind: str, sharded: bool):
        lg = lg0.clone().requires_grad_(True)
        v = v0.clone().requires_grad_(True)
        sh = shard if sharded else None
        e = shard.edges if sharded else slice(None)
        ids_e, mask_e = ids[e], mask[e]
        if kind == "softmax":
            alpha = segment.segment_softmax(lg[e], ids_e, N, mask=mask_e, shard=sh)
            y = segment.segment_sum(v[e] * alpha[..., None], ids_e, N, mask=mask_e, shard=sh)
        else:
            y = (segment.segment_sum(v[e] * torch.tanh(lg[e])[..., None], ids_e, N,
                                     mask=mask_e, shard=sh)
                 + torch.sin(segment.segment_mean(v[e], ids_e, N, mask=mask_e, shard=sh)))
        if sharded:
            y = mp.gather(y, 0)
        (dlg,) = torch.autograd.grad((y ** 3 * w).sum(), lg, create_graph=True)
        loss = (dlg * dlg).sum() + (y * y).sum()
        loss.backward()
        return [y.detach(), dlg.detach(), lg.grad, v.grad]

    out = {}
    for kind in ("sums", "softmax"):
        want, got = run(kind, False), run(kind, True)
        # a rank's logits and values take gradients on its own edges: sum them
        got[1:] = [sharding._all_reduce(t, group) for t in got[1:]]
        out[kind] = max(float((u - v).abs().max() / v.abs().max()) for u, v in zip(got, want))
    owners = [set((torch.arange(E)[mask & (ids == n)] // (E // size)).tolist())
              for n in range(N)]
    out["straddling"] = sum(len(o) > 1 for o in owners)
    return out
