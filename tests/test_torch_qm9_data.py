"""The QM9 slice's data and CLIs: the port's reader, split, loader subsets
and synthetic molecules against the JAX package's, and the committed JAX
fixture checkpoint evaluated by the port.

Fixture parity: ``runs/qm9_fixture/ckpt_best`` (trained by the JAX package)
is restored with the JAX package's CheckpointManager, its EMA params are
converted by utils/convert.py, and the port's ``train/test_qm9.py``
evaluation runs the fixture's test split (8 molecules) on the CPU.  Its 12
MAEs are held to 1e-4 relative of the JAX package's own ``test_qm9``
evaluation, run on the CPU on a copy of the checkpoint (that CLI writes
into its run directory, and ``runs/qm9_fixture`` is committed evidence).
The gap to the committed ``eval_test.json``, taken on a TPU, is printed
(``pytest -s``), not held.

The npz side (``data/prep.py`` and ``QM9NpzDataset``) on the 96 molecules
of ``tests/fixtures/train/qm9_train.db``: ``save_qm9_npz`` writes the JAX
package's arrays bit for bit, ``QM9NpzDataset`` gives its samples bit for
bit (normalized, raw, a target subset, ``max_samples``), and
``compute_qm9_stats_arrays`` its JSON; ``compute_qm9_stats`` on the
database (float64 sums, as the JAX package's) equals the float32 array
path's to 1e-6 relative.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.data import prep as jprep
from equivarianttransformermpnn4quantumcomputations_tpu.data import loader as jloader
from equivarianttransformermpnn4quantumcomputations_tpu.data import qm9 as jqm9
from equivarianttransformermpnn4quantumcomputations_tpu.data import synthetic as jsynth
from equivarianttransformermpnn4quantumcomputations_tpu.models.qm9 import (
    EquiformerV2QM9 as JaxQM9,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import schedules as jsched
from equivarianttransformermpnn4quantumcomputations_tpu.train import test_qm9 as jtest_qm9
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs import qm9 as tcfg
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import loader as tloader
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import prep as tprep
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import qm9 as tqm9
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import synthetic as tsynth
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import test_qm9, train_qm9
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

ROOT = Path(__file__).resolve().parents[1]
FIX = ROOT / "tests" / "fixtures"
RUN = ROOT / "runs" / "qm9_fixture"
MODEL_KEYS = ("num_layers", "sphere_channels", "attn_hidden_channels", "num_heads",
              "attn_alpha_channels", "attn_value_channels", "ffn_hidden_channels", "lmax",
              "mmax", "edge_channels", "num_rbf", "max_num_elements", "cutoff", "avg_degree")


@pytest.mark.parametrize("kw", [dict(), dict(normalize=False), dict(target_indices=[10, 1])],
                         ids=["normalized", "raw", "subset"])
def test_qm9_dataset_round_trip_matches_jax(kw):
    db, stats = str(FIX / "qm9_tiny.db"), str(FIX / "qm9_full_stats.json")
    t, j = tqm9.QM9Dataset(db, stats, **kw), jqm9.QM9Dataset(db, stats, **kw)
    assert len(t) == len(j) == 3
    for i in range(3):
        a, b = t[i], j[i]
        np.testing.assert_array_equal(a.atomic_numbers, b.atomic_numbers)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.pos.dtype == np.float32 and a.y.dtype == np.float32
    for arr_t, arr_j in zip(tqm9.load_qm9_stats(stats), jqm9.load_qm9_stats(stats)):
        np.testing.assert_array_equal(arr_t, arr_j)
    assert tqm9.PROPERTY_ORDER == jqm9.PROPERTY_ORDER
    y = t[0].y
    np.testing.assert_array_equal(
        tqm9.denormalize_targets(y, t.mean, t.std, kw.get("target_indices")),
        jqm9.denormalize_targets(y, j.mean, j.std, kw.get("target_indices")))


@pytest.mark.parametrize("n", [3, 96, 1000])
def test_random_split_matches_jax(n):
    for a, b in zip(tqm9.qm9_random_split(n, 0.15, 0.15), jqm9.qm9_random_split(n, 0.15, 0.15)):
        np.testing.assert_array_equal(a, b)


def test_loader_subset_and_synthetic_molecules_match_jax(monkeypatch):
    """PaddedLoader(indices=...) over SyntheticMolecules: the same batches as
    the JAX loader's fixed-degree batches (its numpy graph builder), two
    shuffled epochs."""
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    ts = tsynth.SyntheticMolecules(n_samples=12, n_atoms=6, seed=3, targets=12)
    js = jsynth.SyntheticMolecules(n_samples=12, n_atoms=6, seed=3, targets=12)
    for a, b in zip(ts.samples, js.samples):
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.y, b.y)
        np.testing.assert_array_equal(a.forces, b.forces)
    idx = [0, 2, 3, 5, 7, 8, 11, 9]
    n_pad, e_pad = tloader.infer_pad_sizes(ts, 5.0, 8, 4, fixed_degree=True)
    tl = tloader.PaddedLoader(ts, 4, 5.0, 8, n_pad, e_pad, indices=idx, shuffle=True,
                              seed=1, prefetch=0, fixed_degree=True)
    jl = jloader.PaddedLoader(js, 4, 5.0, 8, n_pad, e_pad, indices=idx, shuffle=True,
                              seed=1, prefetch=0, fixed_degree=True)
    assert len(tl) == len(jl) == 2
    for epoch in range(2):
        tl.set_epoch(epoch), jl.set_epoch(epoch)
        for a, b in zip(tl, jl):
            a, b = a.asdict(), b.asdict()
            for k in ("atomic_numbers", "pos", "edge_src", "edge_dst", "edge_mask", "y"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_fixture_ema_params(run_dir: str, cfg: dict):
    """The fixture's EMA params, restored by the JAX package's
    CheckpointManager into an abstract TrainState of the fixture's config."""
    model = JaxQM9(**{k: cfg[k] for k in MODEL_KEYS}, fixed_degree=True)
    N, E, B = 16, 64, 2
    fb = dict(atomic_numbers=jnp.ones(N, jnp.int32), pos=jnp.zeros((N, 3)),
              graph_idx=jnp.repeat(jnp.arange(B), N // B), edge_src=jnp.zeros(E, jnp.int32),
              edge_dst=jnp.repeat(jnp.arange(N), E // N), edge_shift=jnp.zeros((E, 3), jnp.int32),
              edge_mask=jnp.zeros(E, bool), cell=jnp.tile(jnp.eye(3), (B, 1, 1)),
              node_mask=jnp.ones(N, bool))
    tx = jtrainer.make_optimizer(jsched.warmup_cosine(cfg["lr"], 10, 100),
                                 cfg["weight_decay"], cfg["grad_clip"])
    shapes = jax.eval_shape(
        lambda: jtrainer.create_train_state(model.init(jax.random.PRNGKey(0), fb), tx))
    dev = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=dev), shapes)
    state, _ = JaxCheckpointManager(run_dir).restore("ckpt_best", target)
    return state.ema_params


def test_fixture_checkpoint_eval_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)  # the checkpoint's config names the db relative to the root
    run = tmp_path / "qm9_fixture"
    run.mkdir()
    shutil.copytree(RUN / "ckpt_best", run / "ckpt_best")
    shutil.copy(RUN / "ckpt_best.meta.json", run)
    cfg = json.loads((RUN / "ckpt_best.meta.json").read_text())["config"]

    jtest_qm9.main(["--checkpoint", "ckpt_best", "--run-dir", str(run), "--split", "test"])
    jax_eval = json.loads((run / "eval_test.json").read_text())
    sd = flax_to_state_dict(_jax_fixture_ema_params(str(run), cfg))
    out = test_qm9.evaluate_state_dict(cfg, sd, "test", "cpu", str(tmp_path))
    assert out["count"] == jax_eval["count"] == 8
    assert out["mae"].keys() == jax_eval["mae"].keys()
    tpu = json.loads((RUN / "eval_test.json").read_text())["mae"]
    for k, v in out["mae"].items():
        jv = jax_eval["mae"][k]
        print(f"  {k:8s} port {v:.6g}  JAX CPU {jv:.6g} (rel {abs(v - jv) / jv:.1e})  "
              f"committed (TPU) {tpu[k]:.6g}  gap to TPU {abs(v - tpu[k]) / tpu[k]:.2e}")
        np.testing.assert_allclose(v, jax_eval["mae"][k], rtol=1e-4, err_msg=k)


def test_qm9_clis_write_only_their_own_run_dir(tmp_path, monkeypatch):
    """One CPU epoch of the fixture config, then its evaluation; every port
    config writes under runs/qm9_torch* or runs/qm9_fixture_torch, never
    into the committed runs/qm9_fixture."""
    monkeypatch.chdir(ROOT)
    for name, cfg in train_qm9.CONFIGS.items():
        assert cfg["run_dir"].startswith(("runs/qm9_torch", "runs/qm9_fixture_torch")), name
    assert tcfg.config_fixture["run_dir"] != "runs/qm9_fixture"
    run = tmp_path / "run"
    state = train_qm9.main(["--config", "fixture", "--device", "cpu", "--epochs", "1",
                            "--conv-fused"], overrides={"run_dir": str(run)})
    assert state.step == (96 - 2 * int(0.15 * 96)) // 8  # 68 training molecules
    assert all(b.ga.so2_conv_2.fused for b in state.model.backbone.blocks)
    out = test_qm9.main(["--checkpoint", str(run / "ckpt_best"), "--device", "cpu"])
    assert out["count"] == 8 and all(np.isfinite(v) for v in out["mae"].values())
    assert sorted(os.listdir(run)) == sorted(
        ["ckpt_best.pt", "ckpt_best.meta.json", "config.json", "losses.csv", "metrics.json",
         "eval_test.json", "predictions.npy", "targets.npy"])


TRAIN_DB = FIX / "train" / "qm9_train.db"


def _molecules():
    """(numbers, positions, raw targets in RAW_KEY_ORDER) of the fixture db."""
    db = tqm9._AseDbLite(str(TRAIN_DB))
    out = []
    for i in range(1, db.count() + 1):
        numbers, positions, data = db.get(i)
        out.append((numbers, positions, [data[k] for k in tqm9.RAW_KEY_ORDER]))
    return out


@pytest.fixture(scope="module")
def npz_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("npz")
    mols = _molecules()
    return (tprep.save_qm9_npz(mols, str(d / "t.npz")),
            jprep.save_qm9_npz(mols, str(d / "j.npz")), mols)


def test_save_qm9_npz_matches_jax(npz_pair):
    t, j, mols = npz_pair
    assert tqm9.RAW_KEY_ORDER == jqm9.RAW_KEY_ORDER
    with np.load(t) as a, np.load(j) as b:
        assert sorted(a.files) == sorted(b.files) == ["numbers", "offsets", "positions",
                                                      "targets_raw"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["offsets"][-1] == len(a["numbers"]) and len(a["targets_raw"]) == len(mols)


@pytest.mark.parametrize("kw", [dict(), dict(normalize=False), dict(target_indices=[10, 1]),
                                dict(max_samples=7)],
                         ids=["normalized", "raw", "subset", "max_samples"])
def test_qm9_npz_dataset_matches_jax(npz_pair, kw):
    path, _, mols = npz_pair
    stats = str(FIX / "qm9_full_stats.json")
    t, j = tqm9.QM9NpzDataset(path, stats, **kw), jqm9.QM9NpzDataset(path, stats, **kw)
    assert len(t) == len(j) == min(len(mols), kw.get("max_samples", len(mols)))
    for i in range(len(t)):
        a, b = t[i], j[i]
        for k in ("atomic_numbers", "pos", "y"):
            assert getattr(a, k).dtype == getattr(b, k).dtype, k
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    # the npz path gives the database path's samples
    db = tqm9.QM9Dataset(str(TRAIN_DB), stats, **kw)
    for i in (0, len(t) - 1):
        np.testing.assert_array_equal(t[i].pos, db[i].pos)
        np.testing.assert_allclose(t[i].y, db[i].y, rtol=1e-6, atol=1e-6)


def test_qm9_stats_match_jax(tmp_path):
    raw = np.asarray([m[2] for m in _molecules()])
    got = tprep.compute_qm9_stats_arrays(raw, str(tmp_path / "t" / "stats.json"))
    want = jprep.compute_qm9_stats_arrays(raw, str(tmp_path / "j" / "stats.json"))
    assert got == want and got["count"] == 96
    with open(tmp_path / "t" / "stats.json") as f:
        assert json.load(f) == want
    # the database path (float64) against the array path (float32)
    from_db = tprep.compute_qm9_stats(str(TRAIN_DB), str(tmp_path / "db.json"))
    assert from_db["count"] == got["count"] and from_db["stats"].keys() == got["stats"].keys()
    for name, st in got["stats"].items():
        for k, v in st.items():
            np.testing.assert_allclose(from_db["stats"][name][k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {k}")
    # the loader reads what the tool writes
    mean, std = tqm9.load_qm9_stats(str(tmp_path / "db.json"))
    assert mean.shape == std.shape == (12,) and np.all(std > 0)
