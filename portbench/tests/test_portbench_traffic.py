"""Every cell's traffic is the same from one seed and differs from another;
a seed changes the order and the coordinates, never the amount of work."""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench.harness.common import ROOT, load_cell
from portbench.traffic import labelled_pool, mixed_requests

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
BIG = 2 ** 31 + 12345


def _draw(cell, seed):
    tr = dict(cell.traffic)
    if tr["generator"] == "labelled_pool":
        tr["pool"] = 8
        return labelled_pool.generate(tr, seed)
    return [s for r in mixed_requests.generate(tr, seed, 6) for s in r]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
                                     for k in x) for x, y in zip(a, b))


@pytest.mark.parametrize("name", CELLS)
def test_seeded_traffic(name):
    cell = load_cell(name)
    a, b, c = _draw(cell, BIG), _draw(cell, BIG), _draw(cell, BIG + 1)
    assert _same(a, b)
    assert not _same(a, c)


@pytest.mark.parametrize("name", CELLS)
def test_same_work_for_every_seed(name):
    cell = load_cell(name)
    sizes = [sorted(len(s.get("z", s.get("atomic_numbers"))) for s in _draw(cell, seed))
             for seed in (1, BIG)]
    assert sizes[0] == sizes[1]


def test_request_sizes_log_uniform():
    tr = load_cell("matpes-serve-mixed16").traffic
    sizes = mixed_requests.request_sizes(tr, 400)
    assert sizes.shape == (400, tr["structures_per_request"])
    assert sizes.min() >= tr["atoms_min"] and sizes.max() <= tr["atoms_max"]
    # log-uniform between 8 and 128: the median near sqrt(8 * 128) = 32
    assert 28 <= np.median(sizes) <= 36


def test_labels_are_lennard_jones():
    s = labelled_pool.generate(dict(atoms=30, pool=4), 3)
    assert all(np.isfinite(x["forces"]).all() and np.isfinite(x["energy"]) for x in s)
    e = np.array([x["energy"] for x in s])
    assert abs(e.mean()) < 1e-5 and e.std() == pytest.approx(1.0, rel=1e-4)
