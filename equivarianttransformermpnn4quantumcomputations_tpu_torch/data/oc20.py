"""OC20 S2EF dataset: lazy extxyz reader with the OCP normalization.

The port's own copy of the JAX package's data/oc20.py (``OC20Dataset``;
reference models/data_loader_oc20v2.py):

* lazy access to a directory of extxyz trajectory files through a
  cumulative frame-count index (reference :27-168), read by the port's
  pure-python ``data/extxyz.py`` (no ase);
* the hardcoded OCP energy normalization mean / std (reference :21-24):
  energies become (E - mean) / std and forces F / std;
* fixed atoms from the tags (reference :151-153), as ``GraphSample.fixed``.

The LMDB-backed dataset of the JAX package (``OC20LmdbDataset``,
``convert_to_lmdb``) is not ported: ``lmdb`` is not installed (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from .extxyz import read_extxyz
from .graph import GraphSample

__all__ = ["OC20_ENERGY_MEAN", "OC20_ENERGY_STD", "OC20Dataset"]

# OCP normalization (reference data_loader_oc20v2.py:21-24)
OC20_ENERGY_MEAN = -0.7554450631141663
OC20_ENERGY_STD = 2.887317180633545


def _atoms_to_sample(atoms, normalize: bool) -> GraphSample:
    energy = float(atoms.get_potential_energy())
    forces = np.asarray(atoms.get_forces(), np.float32)
    if normalize:
        energy = (energy - OC20_ENERGY_MEAN) / OC20_ENERGY_STD
        forces = forces / OC20_ENERGY_STD
    return GraphSample(
        atomic_numbers=np.asarray(atoms.numbers, np.int32),
        pos=np.asarray(atoms.positions, np.float32),
        cell=np.asarray(atoms.cell[:], np.float32),
        pbc=bool(atoms.pbc.any()),
        energy=energy,
        forces=forces,
        fixed=np.asarray(atoms.get_tags(), np.int64) > 0,
    )


class OC20Dataset:
    """Lazy extxyz-backed dataset over a directory (or list) of trajectory
    files.

    ``quick_init=True`` estimates the frame counts from a sample of
    ``quick_init_sample`` files instead of parsing every file up front
    (reference data_loader_oc20v2.py:57-83); an index past the true end of
    a file then reads its last frame.
    """

    def __init__(self, paths: Sequence[str] | str, normalize: bool = True,
                 max_samples: int | None = None, quick_init: bool = False,
                 quick_init_sample: int = 10):
        if isinstance(paths, str):
            if os.path.isdir(paths):
                paths = sorted(os.path.join(paths, f) for f in os.listdir(paths) if "xyz" in f)
            else:
                paths = [paths]
        self.paths = list(paths)
        self.normalize = normalize
        self.quick_init = quick_init
        if quick_init:
            sample = self.paths[: max(1, min(quick_init_sample, len(self.paths)))]
            per_file = [len(read_extxyz(p, index=":")) for p in sample]
            counts = [max(1, int(sum(per_file) / len(per_file)))] * len(self.paths)
        else:
            counts = [len(read_extxyz(p, index=":")) for p in self.paths]
        self.cumsum = np.concatenate([[0], np.cumsum(counts)])
        self.n = int(self.cumsum[-1])
        if max_samples is not None:
            self.n = min(self.n, max_samples)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int) -> GraphSample:
        f = int(np.searchsorted(self.cumsum, idx, side="right")) - 1
        local = idx - int(self.cumsum[f])
        try:
            atoms = read_extxyz(self.paths[f], index=local)
        except IndexError:
            if not self.quick_init:
                raise
            atoms = read_extxyz(self.paths[f], index=-1)
        return _atoms_to_sample(atoms, self.normalize)
