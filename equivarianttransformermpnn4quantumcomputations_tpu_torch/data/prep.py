"""QM9 preparation tools that need neither ``ase`` nor ``torch_geometric``
(the port's own copy of the JAX package's data/prep.py, after the
reference's datasets/QM9 scripts):

* ``save_qm9_npz``: the one-file npz dump that ``data/qm9.py:QM9NpzDataset``
  reads;
* ``compute_qm9_stats_arrays``: the per-property statistics JSON (paper
  order and units: mean, std, min, max, 1st and 99th percentiles) that
  ``data/qm9.py:load_qm9_stats`` reads, from a raw-target array
  (reference DatasetStastics/datasetstatistics.py);
* ``compute_qm9_stats``: the same JSON from an ASE sqlite database, read
  by ``data/qm9.py``'s own reader (``_AseDbLite``), not ``ase.db``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .qm9 import _PAPER_KEYS, PROPERTY_ORDER, RAW_KEY_ORDER, _AseDbLite, paper_targets

__all__ = ["save_qm9_npz", "compute_qm9_stats_arrays", "compute_qm9_stats"]


def save_qm9_npz(molecules, out_path: str) -> str:
    """Write ``molecules``, an iterable of (numbers int[n], positions
    float[n, 3], raw targets float[12] in ``RAW_KEY_ORDER``), as one
    compressed npz: the atoms concatenated, ``offsets`` the molecule
    boundaries.  Returns ``out_path``."""
    numbers, positions, targets, offsets = [], [], [], [0]
    for z, pos, y in molecules:
        numbers.append(np.asarray(z, np.int32))
        positions.append(np.asarray(pos, np.float32).reshape(len(z), 3))
        targets.append(np.asarray(y, np.float32).reshape(12))
        offsets.append(offsets[-1] + len(z))
    np.savez_compressed(out_path, numbers=np.concatenate(numbers),
                        positions=np.concatenate(positions),
                        offsets=np.asarray(offsets, np.int64), targets_raw=np.stack(targets))
    return out_path


def _write_stats(arr: np.ndarray, out_json: str) -> dict:
    """The stats JSON of the paper-order array ``arr`` [n, 12], computed in
    its own type (float32 from raw arrays, float64 from a database, as in
    the JAX package)."""
    stats = {}
    for j, name in enumerate(PROPERTY_ORDER):
        col = arr[:, j]
        stats[name] = {"mean": float(col.mean()), "std": float(col.std()),
                       "min": float(col.min()), "max": float(col.max()),
                       "p1": float(np.percentile(col, 1)), "p99": float(np.percentile(col, 99))}
    out = {"count": int(arr.shape[0]), "stats": stats}
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(out, f, indent=2)
    return out


def compute_qm9_stats_arrays(targets_raw, out_json: str) -> dict:
    """The stats JSON of raw targets [n, 12] (``RAW_KEY_ORDER``, raw units),
    written to ``out_json`` and returned."""
    arr = np.stack([paper_targets(dict(zip(RAW_KEY_ORDER, row)))
                    for row in np.asarray(targets_raw, np.float64)])
    return _write_stats(arr, out_json)


def compute_qm9_stats(db_path: str, out_json: str) -> dict:
    """The stats JSON of every molecule of an ASE sqlite database (the
    reference's QM9 db: raw properties in each row's data), written to
    ``out_json`` and returned."""
    db = _AseDbLite(db_path)
    rows = [db.get(i)[2] for (i,) in db.con.execute("SELECT id FROM systems ORDER BY id")]
    arr = np.asarray([[d[k] * s for k, s in _PAPER_KEYS] for d in rows], np.float64)
    return _write_stats(arr, out_json)
