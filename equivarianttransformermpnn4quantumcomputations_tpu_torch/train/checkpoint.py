"""Checkpoints: ``torch.save`` of the train state, with the JAX package's
``ckpt_*.meta.json`` schema beside it.

Port of the JAX package's train/checkpoint.py (which writes orbax
directories): ``<run_dir>/<name>.pt`` holds model, optimizer (AdamW moments,
schedule count, guard counters), EMA and step; ``<name>.meta.json`` holds
``{"config": ..., **extra}``.  Writes are atomic (temporary file, then
``os.replace``); the last ``KEEP_PERIODIC`` periodic checkpoints are kept;
``install_sigterm_checkpoint`` writes ``ckpt_emergency`` on SIGTERM.  A
manager made with ``primary=False`` (every rank but 0 of a multi-process
run) writes nothing; ``restore`` works on every rank.  Every rank calls the
save methods all the same: a sharded train state gathers its whole
``state_dict()`` over the ranks (parallel/sharding.py), and rank 0 writes it.
"""

from __future__ import annotations

import json
import os
import signal
from typing import Any, Callable, Mapping

import torch

__all__ = ["CheckpointManager", "install_sigterm_checkpoint", "KEEP_PERIODIC"]

KEEP_PERIODIC = 2


class CheckpointManager:
    def __init__(self, run_dir: str, config: Mapping[str, Any] | None = None,
                 primary: bool = True):
        self.primary = primary
        self.run_dir = run_dir
        if primary:
            os.makedirs(run_dir, exist_ok=True)
        self.config = dict(config or {})

    def _path(self, name: str) -> str:
        return os.path.join(self.run_dir, f"{name}.pt")

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.run_dir, f"{name}.meta.json")

    def save(self, name: str, state, extra: Mapping[str, Any] | None = None) -> None:
        """Save a TrainState (anything with ``state_dict()``) + metadata."""
        sd = state.state_dict()   # on every rank: a sharded state gathers
        if not self.primary:
            return
        tmp = self._path(name) + ".tmp"
        torch.save(sd, tmp)
        os.replace(tmp, self._path(name))
        meta = {"config": self.config, **(dict(extra) if extra else {})}
        tmp = self._meta_path(name) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2, default=str)
        os.replace(tmp, self._meta_path(name))

    def _periodic(self) -> list[str]:
        return sorted(d[:-3] for d in os.listdir(self.run_dir)
                      if d.startswith("ckpt_epoch_") and d.endswith(".pt"))

    def save_periodic(self, epoch: int, state, extra=None) -> None:
        self.save(f"ckpt_epoch_{epoch:05d}", state, {**(extra or {}), "epoch": epoch})
        if not self.primary:
            return
        for old in self._periodic()[:-KEEP_PERIODIC]:
            for p in (self._path(old), self._meta_path(old)):
                if os.path.exists(p):
                    os.remove(p)

    def save_best(self, state, extra=None) -> None:
        self.save("ckpt_best", state, extra)

    def restore(self, name: str, state) -> dict:
        """Load checkpoint ``name`` into ``state`` in place; returns its meta."""
        sd = torch.load(self._path(name), map_location="cpu", weights_only=True)
        state.load_state_dict(sd)
        meta = {}
        if os.path.exists(self._meta_path(name)):
            with open(self._meta_path(name)) as f:
                meta = json.load(f)
        return meta

    def latest_name(self) -> str | None:
        if os.path.exists(self._path("ckpt_emergency")):
            return "ckpt_emergency"
        periodic = self._periodic()
        return periodic[-1] if periodic else None


def install_sigterm_checkpoint(get_state: Callable[[], Any], manager: CheckpointManager):
    """On SIGTERM, write an emergency checkpoint, then exit with 143.
    Returns the handler it replaced, for ``signal.signal`` to restore."""

    def handler(signum, frame):
        try:
            manager.save("ckpt_emergency", get_state(), {"reason": "sigterm"})
        finally:
            raise SystemExit(143)

    return signal.signal(signal.SIGTERM, handler)
