"""A pool of QM9-like molecules with 12 targets, for training.

The sizes follow the traffic's ``sizes`` histogram (``[atoms, weight]``
pairs), turned into whole counts of the ``pool`` by largest remainders, so
every seed trains the same sizes; the seed orders them and draws each
molecule.  A molecule of n atoms has ``min(heavy_max, max(1, round(n / 2)))``
heavy atoms, drawn from ``heavy_elements`` (atomic number -> share), and
hydrogens for the rest.  Geometry: the heavy atoms grow as a random tree,
each bonded to an earlier one at a length drawn from ``heavy_bond``; each
hydrogen bonds to a heavy atom at a length from ``h_bond``; no atom takes
more than four bonds.  A placement is kept only where every other pair is at
least ``clash_heavy`` apart (two heavy atoms) or ``clash_h`` (a hydrogen in
the pair); both lie above ``min_distance``, which no pair undercuts.  No
periodic cell.  Targets: ``targets`` draws of N(0, 1) per molecule, which is
what the program's normalized targets are (mean 0, std 1).
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate", "size_counts", "heavy_count"]

_TRIES = 8           # candidate placements drawn at once for one atom
_ROUNDS = 32         # batches of candidates before the molecule starts over


def size_counts(params: dict) -> tuple[np.ndarray, np.ndarray]:
    """(sizes, counts): the whole number of molecules of each size in the pool
    (largest remainders of the histogram's shares; the seed-free work)."""
    sizes = np.asarray([int(a) for a, _ in params["sizes"]])
    w = np.asarray([float(b) for _, b in params["sizes"]])
    exact = w / w.sum() * int(params["pool"])
    counts = np.floor(exact).astype(np.int64)
    short = int(params["pool"]) - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:short]] += 1
    return sizes, counts


def heavy_count(n: int, heavy_max: int) -> int:
    return min(heavy_max, max(1, int(round(n / 2))))


def _unit(rng, shape: tuple) -> np.ndarray:
    v = rng.normal(size=shape + (3,))
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _grow(rng, M: int, n: int, h: int, p: dict) -> np.ndarray:
    """Positions [M, n, 3] of M molecules of n atoms, the first h heavy,
    grown together atom by atom; a molecule in which an atom finds no
    place starts over."""
    pos = np.zeros((M, n, 3))
    bonds = np.zeros((M, n), np.int64)
    heavy = np.arange(n) < h
    alive = np.ones(M, bool)
    ch, cx = float(p["clash_heavy"]), float(p["clash_h"])
    for i in range(1, n):
        is_h = i >= h
        lo, hi = p["h_bond"] if is_h else p["heavy_bond"]
        need = np.where(is_h | ~heavy[:i], cx, ch) ** 2                     # [i]
        todo = np.flatnonzero(alive)
        for _ in range(_ROUNDS):
            open_ = heavy[None, :i] & (bonds[todo, :i] < 4)                   # [m, i]
            parent = (rng.random((len(todo), _TRIES, i)) * open_[:, None, :]).argmax(-1)
            cand = (np.take_along_axis(pos[todo, :i], parent[..., None], 1)
                    + _unit(rng, (len(todo), _TRIES))
                    * rng.uniform(lo, hi, size=(len(todo), _TRIES, 1)))       # [m, T, 3]
            diff = cand[:, :, None, :] - pos[todo, None, :i, :]
            # every other atom far enough; the parent is the bond itself
            ok = ((diff * diff).sum(-1) >= need) | (np.arange(i) == parent[..., None])
            ok = ok.all(-1) & open_.any(-1)[:, None]                          # [m, T]
            has = ok.any(1)
            first = ok.argmax(1)[has]
            sel = todo[has]
            pos[sel, i] = cand[has, first]
            bonds[sel, parent[has, first]] += 1
            bonds[sel, i] = 1
            todo = todo[~has]
            if not todo.size:
                break
        alive[todo] = False
    if not alive.all():
        pos[~alive] = _grow(rng, int((~alive).sum()), n, h, p)
    return pos


def generate(params: dict, seed: int) -> list[dict]:
    """``params["pool"]`` molecules: dicts with ``z`` [n] int32, ``pos``
    [n, 3] float32 and ``y`` [targets] float32."""
    rng = np.random.default_rng(seed)
    sizes, counts = size_counts(params)
    order = rng.permutation(np.repeat(sizes, counts))
    els = np.asarray([int(z) for z in params["heavy_elements"]])
    share = np.asarray([float(s) for s in params["heavy_elements"].values()])
    ys = rng.normal(size=(len(order), int(params["targets"]))).astype(np.float32)
    out = [None] * len(order)
    for n in sizes:
        at = np.flatnonzero(order == n)
        h = heavy_count(int(n), int(params["heavy_max"]))
        z = np.concatenate([rng.choice(els, size=(len(at), h), p=share / share.sum()),
                            np.ones((len(at), n - h), np.int64)], 1).astype(np.int32)
        pos = _grow(rng, len(at), int(n), h, params)
        pos = (pos - pos.mean(1, keepdims=True)).astype(np.float32)
        for j, k in enumerate(at):
            out[k] = dict(z=z[j], pos=pos[j], y=ys[k])
    return out
