"""Run logging: ``config.json``, ``losses.csv`` per epoch, ``metrics.json``.

The file part of the JAX package's utils/logging.py ``RunLogger`` (its
Weights & Biases part is not ported).  ``primary=False`` (every rank but 0
of a multi-process run) keeps the interface and writes nothing (reference
train_oc20v2_parallel.py:513-535 logs on rank 0 only).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Any, Mapping

__all__ = ["RunLogger"]


class RunLogger:
    def __init__(self, run_dir: str, config: Mapping[str, Any] | None = None,
                 primary: bool = True):
        self.primary = primary
        self.run_dir = run_dir
        if primary:
            os.makedirs(run_dir, exist_ok=True)
        self.t0 = time.time()
        self._csv_path = os.path.join(run_dir, "losses.csv")
        self._csv_file = None
        self._csv_writer = None
        self._metrics: dict[str, Any] = {}
        if config is not None and primary:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(dict(config), f, indent=2, default=str)

    def log_epoch(self, epoch: int, scalars: Mapping[str, float]) -> None:
        """Append one row to losses.csv (header on a new file) and flush."""
        if not self.primary:
            return
        row = {"epoch": epoch, **{k: float(v) for k, v in scalars.items()}}
        if self._csv_writer is None:
            exists = os.path.exists(self._csv_path)
            self._csv_file = open(self._csv_path, "a", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=list(row))
            if not exists:
                self._csv_writer.writeheader()
        self._csv_writer.writerow(row)
        self._csv_file.flush()

    def update_metrics(self, **kwargs) -> None:
        self._metrics.update(kwargs)

    def finalize(self) -> None:
        """Write metrics.json (with the wall time) and close losses.csv."""
        if not self.primary:
            return
        self._metrics["wall_time_sec"] = time.time() - self.t0
        with open(os.path.join(self.run_dir, "metrics.json"), "w") as f:
            json.dump(self._metrics, f, indent=2, default=str)
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = self._csv_writer = None
