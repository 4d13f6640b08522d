"""QM9 dataset: ASE-db reader, paper-order targets, z-score normalization.

The port's own copy of the JAX package's data/qm9.py (reference
models/data_loader_qm9_v4.py):

* 12 targets reordered to paper order, with eV -> meV on the energy targets
  (reference :196-211);
* z-score normalization from the stats JSON (reference :47-98), a zero std
  guarded to 1;
* target subsets (reference :216-222);
* the 80/10/10 random split of ``torch.utils.data.random_split`` with seed
  42 (reference :283-287), by the same ``torch.randperm``;
* ``denormalize_targets`` (reference :323-340).

The database is read with ``sqlite3`` alone (``_AseDbLite``: ASE's sqlite
format, as the reference writes it), so the port needs no ``ase``.
``QM9NpzDataset`` reads the one-file npz dump of ``data/prep.py:save_qm9_npz``
(raw targets in ``RAW_KEY_ORDER``) through the same target pipeline, the
paper order and units taken by one column permutation and scale.
"""

from __future__ import annotations

import json
import os
import sqlite3
from typing import Sequence

import numpy as np
import torch

from .graph import GraphSample

__all__ = ["PROPERTY_ORDER", "RAW_KEY_ORDER", "load_qm9_stats", "paper_targets", "QM9Dataset",
           "QM9NpzDataset", "qm9_random_split", "denormalize_targets"]

# raw (PyG download) column order, as data/prep.py and the npz dump store it
RAW_KEY_ORDER = ["mu", "alpha", "homo", "lumo", "gap", "r2", "zpve", "U0", "U", "H", "G", "Cv"]

# paper order (reference data_loader_qm9_v4.py:44-45)
PROPERTY_ORDER = [
    "α", "Δε", "ε_HOMO", "ε_LUMO", "μ", "C_v",
    "G", "H", "R²", "U", "U₀", "ZPVE",
]

EV_TO_MEV = 1000.0

# paper order as (raw PyG key, unit scale)
_PAPER_KEYS = (
    ("alpha", 1.0), ("gap", EV_TO_MEV), ("homo", EV_TO_MEV), ("lumo", EV_TO_MEV),
    ("mu", 1.0), ("Cv", 1.0), ("G", EV_TO_MEV), ("H", EV_TO_MEV), ("r2", 1.0),
    ("U", EV_TO_MEV), ("U0", EV_TO_MEV), ("zpve", EV_TO_MEV),
)
# the same as a column permutation of the raw columns and a scale
_PAPER_FROM_RAW_IDX = np.asarray([RAW_KEY_ORDER.index(k) for k, _ in _PAPER_KEYS], np.int64)
_PAPER_SCALE = np.asarray([s for _, s in _PAPER_KEYS], np.float32)


def load_qm9_stats(json_path: str) -> tuple[np.ndarray, np.ndarray]:
    """(mean [12], std [12]) float32 in paper order from the stats JSON."""
    with open(json_path) as f:
        j = json.load(f)
    stats = j.get("stats", j)
    means, stds = [], []
    for name in PROPERTY_ORDER:
        entry = stats.get(name)
        if entry is None:
            for k in stats:
                if str(k).replace(" ", "") == name.replace(" ", ""):
                    entry = stats[k]
                    break
        if entry is None:
            raise KeyError(f"property {name} missing from {json_path}")
        means.append(float(entry["mean"]))
        stds.append(float(entry["std"]))
    mean = np.asarray(means, np.float32)
    std = np.asarray(stds, np.float32)
    std[std == 0.0] = 1.0
    return mean, std


def paper_targets(d) -> np.ndarray:
    """Raw PyG units -> paper units, paper order (reference
    models/data_loader_qm9_v4.py:196-211).  ``d`` maps raw keys to scalars."""
    return np.asarray([d[k] * s for k, s in _PAPER_KEYS], dtype=np.float32)


class _AseDbLite:
    """Reader for ASE's sqlite3 database format (format version >= 5): one
    row per system in ``systems``; ``numbers`` an int32 blob, ``positions``
    a float64 blob (C order, little-endian), ``data`` a JSON text column."""

    def __init__(self, path: str):
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        # read-only, so the loader's prefetch thread may use it too
        self.con = sqlite3.connect(path, check_same_thread=False)

    def count(self) -> int:
        return self.con.execute("SELECT COUNT(*) FROM systems").fetchone()[0]

    def get(self, row_id: int):
        row = self.con.execute(
            "SELECT numbers, positions, data FROM systems WHERE id=?", (row_id,)
        ).fetchone()
        if row is None:
            raise KeyError(f"no systems row with id={row_id}")
        num_blob, pos_blob, data_txt = row
        numbers = np.frombuffer(num_blob, dtype=np.int32)
        positions = np.frombuffer(pos_blob, dtype=np.float64).reshape(-1, 3)
        return numbers, positions, json.loads(data_txt) if data_txt else {}


class _Targets:
    """The target pipeline of both datasets: subsets, then the z-score of
    the stats JSON (``stats_json`` or ``qm9_full_stats.json`` beside the
    data) unless ``normalize=False``."""

    def _init_targets(self, data_path: str, stats_json: str | None, normalize: bool,
                      target_indices: Sequence[int] | None):
        self.normalize = normalize
        self.target_indices = (np.asarray(target_indices)
                               if target_indices is not None else None)
        if normalize:
            if stats_json is None:
                stats_json = os.path.join(os.path.dirname(data_path), "qm9_full_stats.json")
            self.mean, self.std = load_qm9_stats(stats_json)
        else:
            self.mean = np.zeros(12, np.float32)
            self.std = np.ones(12, np.float32)

    def _sample(self, numbers, positions, targets: np.ndarray) -> GraphSample:
        mean, std = self.mean, self.std
        if self.target_indices is not None:
            targets = targets[self.target_indices]
            mean, std = mean[self.target_indices], std[self.target_indices]
        if self.normalize:
            targets = (targets - mean) / std
        return GraphSample(atomic_numbers=np.asarray(numbers, np.int32),
                           pos=np.asarray(positions, np.float32), y=targets)


class QM9Dataset(_Targets):
    """ASE-db backed QM9 dataset of GraphSamples (paper units and order,
    z-scored unless ``normalize=False``)."""

    def __init__(self, db_path: str, stats_json: str | None = None,
                 max_samples: int | None = None, normalize: bool = True,
                 target_indices: Sequence[int] | None = None):
        self._db = _AseDbLite(db_path)
        self.keys = list(range(1, self._db.count() + 1))[:max_samples]
        self._init_targets(db_path, stats_json, normalize, target_indices)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx: int) -> GraphSample:
        numbers, positions, data = self._db.get(self.keys[idx])
        return self._sample(numbers, positions, paper_targets(data))


class QM9NpzDataset(_Targets):
    """npz-backed QM9 dataset (the JAX package's), the same targets as
    ``QM9Dataset``.  The npz (``data/prep.py:save_qm9_npz``): ``numbers``
    int32 and ``positions`` float32 [A, 3] concatenated over the molecules,
    ``offsets`` int64 [N + 1] their boundaries, ``targets_raw`` float32
    [N, 12] in ``RAW_KEY_ORDER`` (raw PyG units)."""

    def __init__(self, npz_path: str, stats_json: str | None = None,
                 max_samples: int | None = None, normalize: bool = True,
                 target_indices: Sequence[int] | None = None):
        with np.load(npz_path) as f:
            self.numbers = np.asarray(f["numbers"], np.int32)
            self.positions = np.asarray(f["positions"], np.float32)
            self.offsets = np.asarray(f["offsets"], np.int64)
            raw = np.asarray(f["targets_raw"], np.float32)
        # paper_targets for every molecule at once
        self.targets = (raw[:, _PAPER_FROM_RAW_IDX] * _PAPER_SCALE).astype(np.float32)
        self.n = len(self.targets) if max_samples is None else min(len(self.targets),
                                                                    max_samples)
        self._init_targets(npz_path, stats_json, normalize, target_indices)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> GraphSample:
        a, b = int(self.offsets[idx]), int(self.offsets[idx + 1])
        return self._sample(self.numbers[a:b], self.positions[a:b], self.targets[idx])


def qm9_random_split(n: int, val_split: float = 0.1, test_split: float = 0.1,
                     seed: int = 42):
    """(train, val, test) index arrays of ``torch.utils.data.random_split``
    with ``torch.Generator().manual_seed(seed)``: ``torch.randperm`` sliced
    in that order (reference :278-287)."""
    n_val, n_test = int(val_split * n), int(test_split * n)
    n_train = n - n_val - n_test
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed)).numpy()
    return perm[:n_train], perm[n_train:n_train + n_val], perm[n_train + n_val:]


def denormalize_targets(y_norm, mean, std, target_indices=None):
    if target_indices is not None:
        mean = mean[np.asarray(target_indices)]
        std = std[np.asarray(target_indices)]
    return y_norm * std + mean
