"""Worker processes of the pipeline tests (tests/test_torch_pipeline.py,
tests/test_torch_pipeline_cli.py).

This module imports the port, torch and numpy only, never JAX: spawned
children import it afresh.  Each worker joins a gloo group on the CPU
(tests/torch_parallel_helpers.py) and writes its results to
``out_dir/rank<r>.pt``.
"""

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import torch_parallel_helpers as H
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
    init_weights,
    matpes_energy_forces,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import data_parallel
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import pipeline
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    make_matpes_train_step,
    matpes_loss,
)

# the executor's real blocks: 4 layers (a stage of 1 or 2 at pipe 4 or 2)
EXEC_MODEL = dict(num_layers=4, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
                  attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=8,
                  lmax=2, mmax=1, grid_resolution=None, edge_channels=8, num_rbf=16,
                  max_num_elements=10, cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)


# ── the executor in float64 (a toy block stack) ─────────────────────────────

def _toy(L: int, M: int):
    g = torch.Generator().manual_seed(3)
    N, E, C = 5, 12, 4
    u0 = torch.randn(M, N, C, generator=g, dtype=torch.float64)
    A = torch.randn(C, C, generator=g, dtype=torch.float64)
    Ws = torch.randn(L, C, C, generator=g, dtype=torch.float64) / 2
    idx = torch.randint(0, N, (M, E), generator=g)
    mask = torch.rand(M, E, generator=g) > 0.3
    return u0, A, Ws, idx, mask


def _toy_body(block, state):
    """One toy block: a node update from the node features and a masked
    edge sum, every leaf kind of the real state (float carry and
    broadcast, integer indices, a bool mask) passed on."""
    _, W = block
    x, e, idx, mask = state
    msg = torch.zeros_like(x).index_add(0, idx, e * mask[:, None].to(e.dtype))
    return (x + torch.tanh(x @ W) + 0.1 * msg * torch.sin(x), e, idx, mask)


def toy_run(mesh, M: int, pipelined: bool) -> dict:
    """Forward, the gradient of E by the inputs (kept) and the gradients of
    E + |dE/du|^2 by inputs and weights (grad-of-grad)."""
    L = 4
    u0, A, Ws0, idx, mask = _toy(L, M)
    u = u0.clone().requires_grad_(True)
    Ws = [w.clone().requires_grad_(True) for w in Ws0]
    stage = mesh.stage if pipelined else range(L)
    states = [(torch.tanh(u[m]), u[m][idx[m] % u.shape[1]] @ A, idx[m], mask[m])
              for m in range(M)]
    if pipelined:
        outs = pipeline.pipeline_apply(_toy_body, [(l, Ws[l]) for l in stage], states, mesh,
                                       keep=(0,))
    else:
        outs = []
        for s in states:
            for l in range(L):
                s = _toy_body((l, Ws[l]), s)
            outs.append(s)
    energy = sum(torch.sin(o[0]).sum() for o in outs)
    (du,) = torch.autograd.grad(energy, u, create_graph=True)
    loss = energy + (du * du).sum()
    loss.backward()
    return dict(out=torch.stack([o[0] for o in outs]).detach(), du=du.detach(),
                u_grad=u.grad, w_grads={l: Ws[l].grad for l in stage})


# ── the executor on the model's blocks (float32) ────────────────────────────

def exec_batches(M: int) -> list[dict]:
    """M batches of two periodic crystals (4 and 6 atoms, 12 x 6 slots)."""
    return [tgraph.as_tensors(_crystals(seed), "cpu") for seed in range(M)]


def _crystals(seed: int):
    rng = np.random.default_rng(seed)
    samples = []
    for n in (4, 6):
        cell = (np.eye(3) * 4.0 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        samples.append(tgraph.GraphSample(
            atomic_numbers=rng.integers(1, 9, size=n).astype(np.int32),
            pos=(rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32), cell=cell,
            pbc=True, energy=float(rng.normal()),
            forces=rng.normal(size=(n, 3)).astype(np.float32)))
    return tgraph.collate(samples, 5.0, 6, 12, 72, fixed_degree=True)


def model_run(mesh, M: int, pipelined: bool) -> dict:
    """Energies and forces of M micro-batches of the 4-layer model with the
    force graph kept, then the gradients of the summed MatPES losses."""
    model = EquiformerV2MatPES(**EXEC_MODEL)
    init_weights(model, torch.Generator().manual_seed(5))
    model.train()
    batches = exec_batches(M)
    if pipelined:
        for i in range(4):
            if i not in mesh.stage:
                model.backbone.blocks[i] = torch.nn.Identity()
        outs = pipeline.pipeline_energy_forces(model, batches, mesh, create_graph=True)
    else:
        outs = [matpes_energy_forces(model, b, create_graph=True) for b in batches]
    loss = sum(matpes_loss(o, b)[0] for o, b in zip(outs, batches))
    loss.backward()
    return dict(energy=torch.stack([o["energy"] for o in outs]).detach(),
                forces=torch.stack([o["forces"] for o in outs]).detach(),
                grads={n: p.grad.clone() for n, p in model.named_parameters()
                       if p.grad is not None})


def executor_checks() -> dict:
    """4 ranks: the executor at pipe 2 (the mesh (2, 2): each data row its
    own pipeline) and at pipe 4, M = 1 and 3, against the same stack run
    one block after another in this process; the schedule's ticks and this
    stage's bubble ticks of the model run."""
    out = {}
    for data, pipe in ((2, 2), (1, 4)):
        mesh = pipeline.make_dp_pipe_mesh(data, pipe)
        mesh.stage = range(mesh.pipe_index * 4 // pipe, (mesh.pipe_index + 1) * 4 // pipe)
        for M in (1, 3):
            r = dict(toy=toy_run(mesh, M, True), toy_ref=toy_run(mesh, M, False),
                     model_ref=model_run(mesh, M, False), stage=list(mesh.stage))
            mesh.stages.ticks = mesh.stages.bubble = 0
            r["model"] = model_run(mesh, M, True)
            r["ticks"], r["bubble"] = mesh.stages.ticks, mesh.stages.bubble
            out[f"pipe={pipe},M={M}"] = r
    return out


# ── the MatPES step ─────────────────────────────────────────────────────────

def pipeline_step(case: dict) -> dict:
    """One pipeline step of ``case`` on this rank (mesh ``case["mesh"]``,
    micro-batches ``case["batches"]``): the loss, metrics, the whole
    gradients, parameters and EMA after it, the digests of the replicated
    leaves, and the shift's counts."""
    state = H.new_state(case)
    data, pipe = case["mesh"]
    mesh = pipeline.make_dp_pipe_mesh(data, pipe)
    gen = torch.Generator().manual_seed(data_parallel.rank_seed(0, H.multihost.process_index()))
    n_micro = len(case["batches"])
    step = pipeline.make_pipeline_matpes_step(state, mesh, n_micro, generator=gen)
    stacked = data_parallel.stack_microbatches(
        [tgraph.as_tensors(b, "cpu") for b in case["batches"]])
    n = n_micro // data
    local = {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in stacked.items()}
    loss, metrics = step(local)
    grads = _gather_named(step.mean_grads(), mesh)
    sd = state.state_dict()
    replicated = {k: v.clone() for k, v in state.model.named_parameters()
                  if not k.startswith("backbone.blocks.")}
    return dict(loss=float(loss), accepted=bool(metrics["accepted"]),
                metrics={k: float(v) for k, v in metrics.items()
                         if k in ("energy_l1", "force_l1")},
                grads=grads, params=dict(sd["model"]), ema=dict(sd["ema"]),
                replicated=replicated, shifts=dict(mesh.stages.counts),
                stage=list(mesh.stage))


def _gather_named(tensors: dict, mesh) -> dict:
    parts = [None] * mesh.pipe
    dist.all_gather_object(parts, {k: v.detach().clone() for k, v in tensors.items()},
                           group=mesh.stages.group)
    return {k: v for part in parts for k, v in part.items()}


def shard_gather_roundtrip(case: dict) -> dict:
    """A whole state after one local step (so that the AdamW moments
    exist), stage-sharded and gathered back; and the same after a whole
    state is loaded into the sharded one."""
    state = H.new_state(case)
    make_matpes_train_step(state)(tgraph.as_tensors(case["batches"][0], "cpu"))
    whole = torch.utils._pytree.tree_map(
        lambda t: t.clone() if torch.is_tensor(t) else t, state.state_dict())
    mesh = pipeline.make_dp_pipe_mesh(*case["mesh"])
    pipeline.pipeline_shard_state(state, mesh)
    names = sorted(n for n, _ in state.model.named_parameters())
    first = state.state_dict()
    state.load_state_dict(whole)
    return dict(whole=whole, gathered=first, reloaded=state.state_dict(), names=names)


def step_worker(rank: int, world: int, port: int, out_dir: str, cases: dict, threads: int,
                roundtrip: bool, executor: bool) -> None:
    """Rank ``rank`` of ``world`` over gloo: every case's pipeline step,
    with ``roundtrip`` the shard / gather round trip, with ``executor`` the
    executor checks (4 ranks)."""
    H._join_group(rank, world, port, threads)
    try:
        out = {name: pipeline_step(case) for name, case in cases.items()}
        if roundtrip:
            out["roundtrip"] = shard_gather_roundtrip(next(iter(cases.values())))
        if executor:
            out["executor"] = executor_checks()
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
