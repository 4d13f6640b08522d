"""Worker processes of the port's multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_native.py).

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
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import data_parallel
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import multihost
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    GuardedAdamW,
    create_train_state,
)

MODELS = {"qm9": EquiformerV2QM9, "oc20": EquiformerV2OC20, "matpes": EquiformerV2MatPES}
DP_STEPS = {"qm9": data_parallel.make_qm9_dp_step, "oc20": data_parallel.make_oc20_dp_step,
            "matpes": data_parallel.make_matpes_dp_step}
TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target, nprocs: int, *args, timeout: float = TIMEOUT_S) -> list[int]:
    """Run ``target(rank, *args)`` in ``nprocs`` spawned processes; returns
    their exit codes, after killing any still running at ``timeout``."""
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
            p.join(10)
        codes.append(p.exitcode)
    return codes


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
