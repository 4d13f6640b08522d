"""Serving requests of periodic structures of mixed sizes.

Each request holds ``structures_per_request`` structures.  The atom counts
of all requests come from a log-uniform law between ``atoms_min`` and
``atoms_max``, drawn once from a fixed base seed, so every run seed serves
the same requests' sizes; the run seed orders the requests and draws each
structure at the density of ``density_atoms`` atoms in a ~6 A cell (each
side scaled by the cube root of its atom count; uniform positions, species
1..79): the recipe of the program's ``utils/profiling.py:mixed_structures``,
frozen here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate", "request_sizes"]

BASE_SEED = 0


def request_sizes(params: dict, n_requests: int) -> np.ndarray:
    """[n_requests, structures_per_request] atom counts (the seed-free work)."""
    rng = np.random.default_rng(BASE_SEED)
    lo, hi = np.log(params["atoms_min"]), np.log(params["atoms_max"])
    k = int(params["structures_per_request"])
    return np.rint(np.exp(rng.uniform(lo, hi, size=(n_requests, k)))).astype(np.int64)


def generate(params: dict, seed: int, n_requests: int) -> list[list[dict]]:
    """``n_requests`` requests, each a list of dicts with ``atomic_numbers``
    [n] int32, ``positions`` [n, 3] and ``cell`` [3, 3] float32."""
    sizes = request_sizes(params, n_requests)
    rng = np.random.default_rng(seed)
    out = []
    for r in rng.permutation(n_requests):
        req = []
        for n in sizes[r]:
            side = 6.0 * (n / params["density_atoms"]) ** (1.0 / 3.0)
            cell = (np.eye(3) * side + rng.normal(size=(3, 3)) * 0.2).astype(np.float32)
            pos = (rng.uniform(0, 1, size=(int(n), 3)) @ cell).astype(np.float32)
            req.append(dict(atomic_numbers=rng.integers(1, 80, size=int(n)).astype(np.int32),
                            positions=pos, cell=cell))
        out.append(req)
    return out
