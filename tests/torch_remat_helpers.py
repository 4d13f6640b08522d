"""Worker process of the remat tests (tests/test_torch_remat.py): the
composite step at model = 2 and the pipelined step at pipe = 2, each with
and without remat, on one gloo group of 2 ranks.

This module imports the port, torch and numpy only, never JAX: spawned
children import it afresh.
"""

from pathlib import Path

import torch
import torch.distributed as dist

import torch_parallel_helpers as H
import torch_pipeline_helpers as PH


def remat_worker(rank: int, world: int, port: int, out_dir: str, composite: dict,
                 pipelined: dict, threads: int) -> None:
    """Rank ``rank`` of ``world`` over gloo: every ``composite`` case's
    composite step, then every ``pipelined`` case's pipeline step; the
    results go to ``out_dir/rank<r>.pt``."""
    H._join_group(rank, world, port, threads)
    try:
        out = {name: H.composite_step(case) for name, case in composite.items()}
        out.update({name: PH.pipeline_step(case) for name, case in pipelined.items()})
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
