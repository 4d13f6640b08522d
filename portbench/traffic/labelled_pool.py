"""A pool of labelled periodic structures for training.

Frozen copy of the program's ``data/synthetic.py:labelled_structures`` recipe
(atoms on jittered sites of a cubic sub-lattice with 2.25 A spacing, so no
two atoms overlap; species 1..29; Lennard-Jones energies and forces of the
central image, per-atom energies z-scored over the pool, forces scaled by the
same std).  Every structure has the traffic's ``atoms`` atoms, so every seed
gives the same work; the seed draws the cells, sites, species and jitter.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate", "lj_energy_forces"]


def lj_energy_forces(pos: np.ndarray, eps: float = 0.1, sigma: float = 1.8):
    """Lennard-Jones energy and forces [n, 3] of one atom cloud."""
    diff = pos[None, :, :] - pos[:, None, :]
    d = np.linalg.norm(diff, axis=-1)
    np.fill_diagonal(d, np.inf)
    sr6 = (sigma / d) ** 6
    e = 2.0 * eps * np.sum(sr6 * sr6 - sr6)
    dv = 4.0 * eps * (-12 * sr6 * sr6 + 6 * sr6) / (d * d)
    f = -np.einsum("ij,ijk->ik", dv, -diff)
    return float(e), f.astype(np.float32)


def generate(params: dict, seed: int) -> list[dict]:
    """``params["pool"]`` structures of ``params["atoms"]`` atoms: dicts with
    ``z`` [n] int32, ``pos`` [n, 3] and ``cell`` [3, 3] float32, ``energy``
    (per atom, normalized) and ``forces`` [n, 3]."""
    rng = np.random.default_rng(seed)
    atoms, n = int(params["atoms"]), int(params["pool"])
    side = int(np.ceil(atoms ** (1.0 / 3.0)))
    raw = []
    for _ in range(n):
        cell = (np.eye(3) * 2.25 * side + rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
        sites = rng.permutation(side ** 3)[:atoms]
        frac = (np.stack([sites // side ** 2, (sites // side) % side, sites % side], 1)
                + 0.5) / side + rng.uniform(-0.04, 0.04, size=(atoms, 3))
        pos = (frac @ cell).astype(np.float32)
        z = rng.integers(1, 30, size=atoms).astype(np.int32)
        e, f = lj_energy_forces(pos)
        raw.append((z, pos, cell, e, f))
    es = np.asarray([e / atoms for _, _, _, e, _ in raw])
    mu, sd = es.mean(), max(es.std(), 1e-6)
    return [dict(z=z, pos=pos, cell=cell, energy=float((e / atoms - mu) / sd),
                 forces=(f / sd).astype(np.float32))
            for z, pos, cell, e, f in raw]
