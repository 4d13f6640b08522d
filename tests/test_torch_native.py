"""The port's C++ neighbour-list builder (data/native.py) against the numpy
neighbour searches of the JAX package and of the port.

The builder returns the numpy path's edges in its order: without a cap the
edge sets (and the arrays) are identical; with a per-destination cap every
destination keeps at most k sources, with the same sorted distances.
Nothing here skips: g++ builds the library at first use, and four
processes building it into one fresh directory at once all succeed.
"""

import multiprocessing as mp

import numpy as np
import pytest

import torch_parallel_helpers as H
from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import native


def _edge_set(src, dst, shift):
    return {(int(s), int(d), *map(int, sh)) for s, d, sh in zip(src, dst, shift)}


def _structure(pbc: bool, seed: int, n: int = 24):
    rng = np.random.default_rng(seed)
    if not pbc:
        return rng.normal(size=(n, 3)) * 2.0, None
    cell = np.array([[3.0, 0, 0], [0.4, 2.8, 0], [0, 0.3, 3.2]]) * (1 + rng.uniform())
    return rng.uniform(0, 1, size=(n, 3)) @ cell, cell


def _numpy_edges(graph_module, monkeypatch, pos, cell, cutoff, k):
    monkeypatch.setattr(graph_module, "USE_NATIVE", False)
    if cell is None:
        return graph_module.radius_graph(pos, cutoff, k)
    return graph_module.radius_graph_pbc(pos, cell, cutoff, k)


def _lengths(pos, cell, src, dst, shift):
    off = 0.0 if cell is None else shift @ cell
    return np.linalg.norm(pos[dst] + off - pos[src], axis=1)


@pytest.mark.parametrize("reference", ["jax_numpy", "port_numpy"])
@pytest.mark.parametrize("pbc", [False, True], ids=["molecule", "periodic"])
def test_native_edges_equal_numpy_without_cap(reference, pbc, monkeypatch):
    pos, cell = _structure(pbc, seed=0)
    got = native.neighbor_list_native(pos, cell, pbc, 3.0, None)
    want = _numpy_edges(jgraph if reference == "jax_numpy" else tgraph, monkeypatch, pos, cell,
                        3.0, None)
    assert len(got[0]) > 0
    assert _edge_set(*got) == _edge_set(*want)
    if reference == "port_numpy":   # and in the same order, with the same dtypes
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("reference", ["jax_numpy", "port_numpy"])
@pytest.mark.parametrize("pbc", [False, True], ids=["molecule", "periodic"])
def test_native_cap_keeps_the_k_closest(reference, pbc, monkeypatch):
    k, cutoff = 5, 4.0
    pos, cell = _structure(pbc, seed=2, n=30)
    got = native.neighbor_list_native(pos, cell, pbc, cutoff, k)
    want = _numpy_edges(jgraph if reference == "jax_numpy" else tgraph, monkeypatch, pos, cell,
                        cutoff, k)
    counts = np.bincount(got[1], minlength=len(pos))
    assert counts.max() <= k and counts.min() > 0
    np.testing.assert_array_equal(counts, np.bincount(want[1], minlength=len(pos)))
    np.testing.assert_array_equal(np.sort(_lengths(pos, cell, *got)),
                                  np.sort(_lengths(pos, cell, *want)))


def test_collate_is_the_same_on_either_path(monkeypatch):
    """A batch of periodic structures and molecules collated through the
    builder equals the numpy path's, array for array."""
    rng = np.random.default_rng(4)
    samples = []
    for i in range(4):
        pos, cell = _structure(i % 2 == 0, seed=10 + i, n=int(rng.integers(5, 12)))
        samples.append(tgraph.GraphSample(atomic_numbers=rng.integers(1, 9, len(pos)),
                                          pos=pos.astype(np.float32),
                                          cell=None if cell is None else cell.astype(np.float32),
                                          pbc=cell is not None))
    args = (samples, 3.5, 6, 4 * 12, 4 * 12 * 8)
    got = tgraph.collate(*args, fixed_degree=True).asdict()
    monkeypatch.setattr(tgraph, "USE_NATIVE", False)
    want = tgraph.collate(*args, fixed_degree=True).asdict()
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_four_processes_build_into_one_directory_at_once(tmp_path):
    pos = np.random.default_rng(5).normal(size=(16, 3)) * 1.5
    barrier = mp.get_context("spawn").Barrier(4)
    codes = H.spawn(H.build_worker, 4, str(tmp_path), barrier, pos, timeout=120)
    assert codes == [0, 0, 0, 0]
    want = [np.load(tmp_path / f"build{r}.npz") for r in range(4)]
    for w in want[1:]:
        for key in ("src", "dst", "shift"):
            np.testing.assert_array_equal(w[key], want[0][key])
    assert sorted(p.name for p in tmp_path.glob("*.so")) == [native.library_path().name]
    assert not list(tmp_path.glob(".*"))    # no temporary file left behind


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "neighborlist.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_FN", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*\n.*error"):
        native.neighbor_list_native(np.zeros((2, 3)), None, False, 3.0, None)
    assert not list((tmp_path / "build").iterdir())
