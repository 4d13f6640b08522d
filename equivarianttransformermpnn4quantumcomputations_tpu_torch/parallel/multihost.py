"""Multi-process execution: the process group from the environment, and the
rank helpers.

Port of the JAX package's parallel/multihost.py (reference
models/train_oc20v2_parallel.py:34-54 reads RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT and calls init_process_group; :334-349 shards the data per rank;
:513-535 writes checkpoints and logs on rank 0 only).  One process per GPU,
as ``torchrun`` starts them:

* ``initialize_from_env()`` calls ``torch.distributed.init_process_group``
  from the environment and is a no-op when the job is single-process
  (world size unset or 1), so a trainer can call it unconditionally.  The
  backend is NCCL on the card (after ``torch.cuda.set_device(LOCAL_RANK)``)
  and gloo on the CPU, unless ``backend=`` or ``ETQ_DIST_BACKEND`` names one
  (gloo also reduces CUDA tensors, through the host, which lets two ranks
  share one card).  A backend that fails to start raises.
* ``process_index()`` / ``process_count()`` / ``is_primary()``: rank helpers
  that work before and without initialization.
* ``host_shard()``: the DistributedSampler analogue, the strided per-rank
  subset that ``data/loader.py:PaddedLoader`` takes with
  ``num_shards`` / ``shard_id``.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

__all__ = ["initialize_from_env", "process_index", "process_count", "is_primary",
           "host_shard"]

BACKENDS = ("nccl", "gloo")


def _env(*names: str, default: str | None = None) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def initialize_from_env(backend: str | None = None, device: str = "cuda",
                        verbose: bool = True) -> bool:
    """Join the process group the environment describes; no-op for a
    one-process job.

    Environment (first match wins):
      world size: WORLD_SIZE | ETQ_NUM_PROCESSES
      rank:       RANK | ETQ_PROCESS_ID
      address:    MASTER_ADDR[:MASTER_PORT] | ETQ_COORDINATOR
                  (default 127.0.0.1:12355)
      backend:    ``backend`` | ETQ_DIST_BACKEND | nccl on ``device`` cuda,
                  gloo on the CPU
      device:     cuda:LOCAL_RANK (default 0) on ``device`` cuda
    Returns True when a multi-process group is (or already was) initialized.
    """
    if dist.is_initialized():
        return True
    world = int(_env("WORLD_SIZE", "ETQ_NUM_PROCESSES", default="1"))
    if world <= 1:
        return False
    rank = int(_env("RANK", "ETQ_PROCESS_ID", default="0"))
    if os.environ.get("MASTER_ADDR"):
        address = f"{os.environ['MASTER_ADDR']}:{_env('MASTER_PORT', default='12355')}"
    else:
        address = _env("ETQ_COORDINATOR", default="127.0.0.1:12355")
    cuda = torch.device(device).type == "cuda"
    backend = backend or _env("ETQ_DIST_BACKEND") or ("nccl" if cuda else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    if cuda:
        torch.cuda.set_device(int(_env("LOCAL_RANK", default="0")))
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    if verbose and rank == 0:
        print(f"multihost: {world} processes at {address}, backend {backend}")
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns the log and checkpoint writes (rank 0)."""
    return process_index() == 0


def host_shard(n: int, num_shards: int | None = None, shard_id: int | None = None) -> slice:
    """The strided per-rank subset of range(n), DistributedSampler's
    semantics (reference train_oc20v2_parallel.py:334-349): shard k takes
    indices k, k+S, k+2S, ... of the (shared-seed) shuffled order."""
    if num_shards is None:
        num_shards = process_count()
    if shard_id is None:
        shard_id = process_index()
    return slice(shard_id, n, num_shards)
