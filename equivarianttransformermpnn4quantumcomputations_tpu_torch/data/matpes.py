"""MatPES-PBE dataset: the official split, Voigt stresses, z-scored energies.

The port's own copy of the JAX package's data/matpes.py, without its
optional pymatgen / monty paths (neither is installed where the port runs):

* ``Structure.as_dict()`` payloads parsed to (Z, Cartesian positions, cell)
  by ``_structure_from_dict``;
* stress from kBar to eV/A^3 in Voigt-6 order (``parse_stress``);
* the official split file, index- or id-keyed, else a seeded 90/5/5 split;
* the per-atom energy z-scored by the *train* split's statistics;
* an optional pickle cache of the parsed entries (one file per split).
"""

from __future__ import annotations

import gzip
import json
import os
import pickle
from typing import Sequence

import numpy as np

from .graph import GraphSample
from .periodic import ATOMIC_NUMBERS

__all__ = ["KBAR_TO_EV_ANG3", "MatPESDataset", "load_matpes", "parse_stress"]

KBAR_TO_EV_ANG3 = 1.0 / 1602.1766


def parse_stress(stress_raw) -> np.ndarray:
    """Voigt-6 stress in eV/A^3 from kBar input (3x3 or Voigt list)."""
    if stress_raw is None:
        return np.zeros(6, np.float32)
    arr = np.asarray(stress_raw, np.float64)
    if arr.shape == (3, 3):
        voigt = np.array([arr[0, 0], arr[1, 1], arr[2, 2], arr[1, 2], arr[0, 2], arr[0, 1]])
    else:
        voigt = arr.flatten()[:6]
    return (voigt * KBAR_TO_EV_ANG3).astype(np.float32)


def _structure_from_dict(d: dict):
    """(Z, Cartesian positions, cell) of a ``Structure.as_dict()`` payload:
    ``lattice.matrix`` (3x3 rows) and ``sites`` with ``species`` (one element
    per site: MatPES entries are ordered crystals) and fractional ``abc``
    (Cartesian ``xyz`` when the dump has it)."""
    cell = np.asarray(d["lattice"]["matrix"], np.float64)
    z, pos = [], []
    for site in d["sites"]:
        z.append(ATOMIC_NUMBERS[site["species"][0]["element"]])
        if "xyz" in site:
            pos.append(np.asarray(site["xyz"], np.float64))
        else:
            pos.append(np.asarray(site["abc"], np.float64) @ cell)
    return np.asarray(z, np.int32), np.asarray(pos, np.float64).reshape(len(z), 3), cell


def _parse_entry(entry: dict):
    """(Z, pos, cell, total energy, forces, Voigt stress) of one entry, with
    MatPES-2025.1's key variants: total ``energy`` or ``energy_per_atom`` x
    the site count; ``forces`` or ``force``."""
    z, pos, cell = _structure_from_dict(entry["structure"])
    pos, cell = pos.astype(np.float32), cell.astype(np.float32)
    energy = entry.get("energy")
    if energy is None:
        epa = entry.get("energy_per_atom")
        energy = float(epa) * len(z) if epa is not None else 0.0
    forces = entry.get("forces")
    if forces is None:
        forces = entry.get("force")
    forces = np.asarray(forces if forces is not None else np.zeros((len(z), 3)), np.float32)
    return z, pos, cell, float(energy), forces, parse_stress(entry.get("stress"))


class MatPESDataset:
    """Parsed entries with an optional pickle cache and z-scored energies.

    ``cache_path``: read the parsed entries from it when it exists (it must
    be a file this program wrote: unpickling runs code), else parse and
    write it.
    """

    def __init__(self, entries: Sequence[dict], normalize_energy: bool = True,
                 energy_mean: float = 0.0, energy_std: float = 1.0,
                 max_samples: int | None = None, cache_path: str | None = None):
        if max_samples is not None:
            entries = entries[:max_samples]
        if cache_path is not None and os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                self.parsed = pickle.load(f)
        else:
            self.parsed = [_parse_entry(e) for e in entries]
            if cache_path is not None:
                tmp = cache_path + ".tmp"
                with open(tmp, "wb") as f:
                    pickle.dump(self.parsed, f)
                os.replace(tmp, cache_path)
        self.normalize_energy = normalize_energy
        self.energy_mean = energy_mean
        self.energy_std = energy_std

    def __len__(self):
        return len(self.parsed)

    def compute_energy_stats(self) -> tuple[float, float]:
        """Per-atom energy mean / std over this (train) set."""
        e = np.asarray([p[3] / max(len(p[0]), 1) for p in self.parsed], np.float64)
        return float(e.mean()), float(max(e.std(), 1e-8))

    def __getitem__(self, idx: int) -> GraphSample:
        z, pos, cell, energy, forces, stress = self.parsed[idx]
        e_per_atom = energy / max(len(z), 1)
        if self.normalize_energy:
            e_per_atom = (e_per_atom - self.energy_mean) / self.energy_std
            forces = forces / self.energy_std
        return GraphSample(atomic_numbers=z, pos=pos, cell=cell, pbc=True,
                           energy=e_per_atom, forces=forces, stress=stress)


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def _split_entries(entries: list, split: dict):
    """(train, val, test) entries of an official split file.  Index-keyed:
    positions in the entry list, and with no ``test`` key every entry in
    neither train nor valid; id-keyed: ``matpes_id`` values."""
    tr = split["train"]
    va = split["valid" if "valid" in split else "val"]
    te = split.get("test")
    if all(isinstance(i, int) for i in list(tr)[:50]):
        tr_s, va_s = set(tr), set(va)
        te_s = set(te) if te is not None else None
        pick = (lambda keep: [e for i, e in enumerate(entries) if keep(i)])
        test = (pick(lambda i: i not in tr_s and i not in va_s) if te_s is None
                else pick(lambda i: i in te_s))
        return pick(lambda i: i in tr_s), pick(lambda i: i in va_s), test
    by_id = {e.get("matpes_id", i): e for i, e in enumerate(entries)}
    return ([by_id[i] for i in tr if i in by_id], [by_id[i] for i in va if i in by_id],
            [by_id[i] for i in (te or []) if i in by_id])


def load_matpes(data_path: str, split_path: str | None = None,
                cache_dir: str | None = None, max_train: int | None = None,
                max_val: int | None = None, max_test: int | None = None,
                normalize_energy: bool = True):
    """The MatPES json(.gz) as (train, val, test, stats): three datasets and
    ``{"energy_mean", "energy_std"}`` of the train split.  Uses the official
    split file when given, else a seeded 90/5/5 random split."""
    if not os.path.exists(data_path):
        raise FileNotFoundError(f"MatPES data not found: {data_path}")
    with _open(data_path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        entries = list(entries.values())
    if split_path is not None:
        with _open(split_path) as f:
            train_e, val_e, test_e = _split_entries(entries, json.load(f))
    else:
        perm = np.random.default_rng(42).permutation(len(entries))
        n_val = int(0.05 * len(entries))
        n_train = len(entries) - 2 * n_val
        train_e = [entries[i] for i in perm[:n_train]]
        val_e = [entries[i] for i in perm[n_train : n_train + n_val]]
        test_e = [entries[i] for i in perm[n_train + n_val :]]

    def cache(name):
        if cache_dir is None:
            return None
        os.makedirs(cache_dir, exist_ok=True)
        return os.path.join(cache_dir, f"{name}_cache.pkl")

    train = MatPESDataset(train_e, normalize_energy=False, max_samples=max_train,
                          cache_path=cache("train"))
    mean, std = train.compute_energy_stats()
    train.normalize_energy = normalize_energy
    train.energy_mean, train.energy_std = mean, std
    val = MatPESDataset(val_e, normalize_energy, mean, std, max_val, cache("val"))
    test = MatPESDataset(test_e, normalize_energy, mean, std, max_test, cache("test"))
    return train, val, test, {"energy_mean": mean, "energy_std": std}
