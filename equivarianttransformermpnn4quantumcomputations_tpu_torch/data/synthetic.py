"""Synthetic labelled molecules and crystals for training without a dataset
on disk.

The port's own copy of the JAX package's data/synthetic.py
(``SyntheticMolecules``, ``SyntheticCrystals``, ``_lj_energy_forces``):
random molecules and periodic cells whose labels come from a Lennard-Jones
surface (central image only), so that training has real signal.
"""

from __future__ import annotations

import numpy as np

from .graph import GraphSample

__all__ = ["SyntheticMolecules", "SyntheticCrystals", "labelled_structures",
           "lj_energy_forces"]


def lj_energy_forces(pos, eps=0.1, sigma=1.8):
    """Lennard-Jones energy (float) and forces [n, 3] of one atom cloud."""
    n = pos.shape[0]
    diff = pos[None, :, :] - pos[:, None, :]
    d = np.linalg.norm(diff, axis=-1)
    np.fill_diagonal(d, np.inf)
    sr6 = (sigma / d) ** 6
    e = 2.0 * eps * np.sum(sr6 * sr6 - sr6)
    # dE/dr_i
    dv = 4.0 * eps * (-12 * sr6 * sr6 + 6 * sr6) / (d * d)
    f = np.zeros_like(pos)
    for i in range(n):
        f[i] = -np.sum(dv[i][:, None] * (pos[i] - pos), axis=0)
    return float(e), f.astype(np.float32)


def _zscored(raw, stats=None):
    """GraphSamples of ``(z, pos, cell, e, f)`` tuples: per-atom energies
    z-scored (over ``raw``, or with ``stats=(mu, sd)``), forces scaled by
    the same std.  Returns the samples and ``(mu, sd)``."""
    es = np.asarray([e / len(z) for z, _, _, e, _ in raw])
    if stats is None:
        mu, sd = es.mean(), max(es.std(), 1e-6)
    else:
        mu, sd = stats
    samples = [
        GraphSample(
            atomic_numbers=z,
            pos=pos,
            cell=cell,
            pbc=True,
            energy=(e / len(z) - mu) / sd,
            forces=(f / sd).astype(np.float32),
            stress=np.zeros(6, np.float32),
        )
        for z, pos, cell, e, f in raw
    ]
    return samples, (float(mu), float(sd))


class SyntheticMolecules:
    """Random molecules with LJ energies, per-atom-normalized, QM9-style
    ``y`` (the same value for each of ``targets`` targets).  Atoms sit on
    jittered sites of a 4 x 2 x 2 lattice of 2 A spacing, collision-free up
    to 8 atoms (larger molecules can put two atoms on one site)."""

    def __init__(self, n_samples=64, n_atoms=8, seed=0, targets=1):
        rng = np.random.default_rng(seed)
        raw = []
        for _ in range(n_samples):
            base = rng.permutation(n_atoms * 2)[:n_atoms]
            grid = np.stack([(base // 4) % 4, (base // 2) % 2, base % 2],
                            axis=1).astype(np.float32)
            pos = grid * 2.0 + rng.normal(size=(n_atoms, 3)).astype(np.float32) * 0.25
            z = rng.integers(1, 9, size=n_atoms).astype(np.int32)
            e, f = lj_energy_forces(pos)
            raw.append((z, pos, e, f))
        es = np.asarray([r[2] / n_atoms for r in raw])
        mu, sd = es.mean(), max(es.std(), 1e-6)
        self.samples = [
            GraphSample(atomic_numbers=z, pos=pos,
                        y=np.full(targets, (e / n_atoms - mu) / sd, np.float32),
                        energy=(e / n_atoms - mu) / sd,
                        forces=(f / sd).astype(np.float32))
            for z, pos, e, f in raw
        ]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


class SyntheticCrystals:
    """Random periodic cells with LJ energies (central image only).

    Energies are per atom and z-scored, forces scaled by the same std.
    ``stats=(mu, sd)``: normalize with external per-atom-energy stats (pass
    the train set's ``.stats`` to val/test so that both share one scale).
    """

    def __init__(self, n_samples=32, n_atoms=6, seed=0, stats=None):
        rng = np.random.default_rng(seed)
        raw = []
        for _ in range(n_samples):
            cell = (np.eye(3) * 6.0 + rng.normal(size=(3, 3)) * 0.2).astype(
                np.float32
            )
            # jittered sub-lattice: atoms can't overlap -> bounded LJ
            frac = (
                rng.permutation(8)[:n_atoms][:, None]
                * np.array([[0.53, 0.31, 0.17]])
                % 1.0
            ) + rng.uniform(-0.04, 0.04, size=(n_atoms, 3))
            pos = (frac @ cell).astype(np.float32)
            z = rng.integers(1, 30, size=n_atoms).astype(np.int32)
            e, f = lj_energy_forces(pos)
            raw.append((z, pos, cell, e, f))
        self.samples, self.stats = _zscored(raw, stats)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def labelled_structures(rng: np.random.Generator, n: int, atoms: int) -> list:
    """``n`` labelled structures of ``atoms`` atoms each, the recipe of
    ``SyntheticCrystals`` at any atom count: atoms on jittered sites of a
    cubic sub-lattice with 2.25 A spacing (no overlaps, bounded energies;
    30 atoms still see more than 20 neighbours within 6 A), z-scored over
    the set."""
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
    return _zscored(raw)[0]
