"""The MatPES slice's data and evaluation: the port's reader against the
JAX package's, and the committed JAX fixture checkpoint evaluated by the
port.

Data: ``tests/fixtures/train/matpes_train.json.gz`` (64 MatPES-format
entries) with its index-keyed split file, and without it (the seeded
90/5/5 split): the same split sizes, atoms, positions, cells, Voigt
stresses, forces, energies and train statistics as the JAX package's
``load_matpes`` (exact, floats within 1e-7).

Fixture parity: ``runs/matpes_fixture/ckpt_best`` (trained by the JAX
package) is restored with the JAX package's CheckpointManager, its EMA
params are converted by utils/convert.py, and the port's
``train/test_matpes.py`` evaluation runs the fixture's test split on the
CPU.  Its energy and force MAEs are held to 1e-5 relative of the JAX
package's own ``test_matpes`` evaluation, run on the CPU on a copy of the
checkpoint (that CLI writes into its run directory, and
``runs/matpes_fixture`` is committed evidence).  The gap to the committed
``eval_test.json``, taken on a TPU at lower matmul precision, is printed
(``pytest -s``), not held.
"""

import gzip
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from equivarianttransformermpnn4quantumcomputations_tpu.data import matpes as jmatpes
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
)
from equivarianttransformermpnn4quantumcomputations_tpu.train import schedules as jsched
from equivarianttransformermpnn4quantumcomputations_tpu.train import test_matpes as jtest
from equivarianttransformermpnn4quantumcomputations_tpu.train import trainer as jtrainer
from equivarianttransformermpnn4quantumcomputations_tpu.train.checkpoint import (
    CheckpointManager as JaxCheckpointManager,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import matpes as tmatpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import test_matpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "fixtures" / "train" / "matpes_train.json.gz"
SPLIT = ROOT / "tests" / "fixtures" / "train" / "matpes_split_train.json.gz"
RUN = ROOT / "runs" / "matpes_fixture"
MODEL_KEYS = ("num_layers", "sphere_channels", "attn_hidden_channels", "num_heads",
              "attn_alpha_channels", "attn_value_channels", "ffn_hidden_channels", "lmax",
              "mmax", "grid_resolution", "edge_channels", "num_rbf", "max_num_elements",
              "cutoff", "avg_degree", "gata", "normalize_attn_output",
              "use_phi_every_layer", "scan_layers")


def _same_datasets(t, j):
    assert len(t) == len(j)
    for i in range(len(t)):
        a, b = t[i], j[i]
        np.testing.assert_array_equal(a.atomic_numbers, b.atomic_numbers)
        for k in ("pos", "cell", "forces", "stress"):
            got, want = getattr(a, k), getattr(b, k)
            assert got.dtype == want.dtype == np.float32, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        assert a.pbc and b.pbc
        np.testing.assert_allclose(a.energy, b.energy, rtol=1e-7, atol=0)


@pytest.mark.parametrize("split", [True, False], ids=["split-file", "seeded-split"])
def test_load_matpes_matches_jax(split):
    sp = str(SPLIT) if split else None
    t = tmatpes.load_matpes(str(DATA), sp)
    j = jmatpes.load_matpes(str(DATA), sp)
    sizes = [len(d) for d in t[:3]]
    assert sizes == [len(d) for d in j[:3]]
    assert sizes == ([48, 8, 8] if split else [58, 3, 3])
    for a, b in zip(t[:3], j[:3]):
        _same_datasets(a, b)
    for k in ("energy_mean", "energy_std"):
        np.testing.assert_allclose(t[3][k], j[3][k], rtol=1e-7, atol=0, err_msg=k)
    # the fixture's train statistics are the committed checkpoint's
    meta = json.loads((RUN / "ckpt_best.meta.json").read_text())["config"]
    if split:
        np.testing.assert_allclose(t[3]["energy_std"], meta["energy_std"], rtol=1e-12)


def test_load_matpes_reads_id_keyed_splits_and_caps(tmp_path):
    """An id-keyed split file (``matpes_id`` values) and the max_* caps."""
    entries = json.loads(gzip.open(DATA, "rt").read())
    ids = [e["matpes_id"] for e in entries]
    split = {"train": ids[:20], "val": ids[20:26], "test": ids[26:30]}
    path = tmp_path / "split.json"
    path.write_text(json.dumps(split))
    t = tmatpes.load_matpes(str(DATA), str(path), max_train=12, max_val=5)
    j = jmatpes.load_matpes(str(DATA), str(path), max_train=12, max_val=5)
    assert [len(d) for d in t[:3]] == [12, 5, 4]
    for a, b in zip(t[:3], j[:3]):
        _same_datasets(a, b)


@pytest.mark.parametrize("raw", [
    None,
    [[1.0, 0.4, -0.3], [0.4, -2.0, 0.7], [-0.3, 0.7, 5.5]],
    [10.0, -20.0, 3.0, 0.5, 0.25, -1.0],
    [10.0, -20.0, 3.0, 0.5, 0.25, -1.0, 7.0],
], ids=["none", "3x3", "voigt", "longer"])
def test_parse_stress_matches_jax(raw):
    got, want = tmatpes.parse_stress(raw), jmatpes.parse_stress(raw)
    assert got.dtype == want.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_array_equal(got, want)
    assert tmatpes.KBAR_TO_EV_ANG3 == jmatpes.KBAR_TO_EV_ANG3


def test_pickle_cache_round_trips(tmp_path):
    """The first load writes one cache per split; the second reads them and
    gives the same samples and statistics."""
    cache = tmp_path / "cache"
    first = tmatpes.load_matpes(str(DATA), str(SPLIT), str(cache))
    assert sorted(p.name for p in cache.iterdir()) == [
        "test_cache.pkl", "train_cache.pkl", "val_cache.pkl"]
    second = tmatpes.load_matpes(str(DATA), str(SPLIT), str(cache))
    assert first[3] == second[3]
    for a, b in zip(first[:3], second[:3]):
        _same_datasets(a, b)


def test_load_matpes_names_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="missing.json.gz"):
        tmatpes.load_matpes(str(tmp_path / "missing.json.gz"))


def _jax_fixture_ema_params(run_dir: str, cfg: dict):
    """The fixture's EMA params, restored by the JAX package's
    CheckpointManager into an abstract TrainState of the fixture's config."""
    model = JaxMatPES(**{k: cfg[k] for k in MODEL_KEYS}, fixed_degree=True)
    N, E, B = 16, 64, 2
    fb = dict(atomic_numbers=jnp.ones(N, jnp.int32), pos=jnp.zeros((N, 3)),
              graph_idx=jnp.repeat(jnp.arange(B), N // B), edge_src=jnp.zeros(E, jnp.int32),
              edge_dst=jnp.repeat(jnp.arange(N), E // N), edge_shift=jnp.zeros((E, 3), jnp.int32),
              edge_mask=jnp.zeros(E, bool), cell=jnp.tile(jnp.eye(3), (B, 1, 1)),
              node_mask=jnp.ones(N, bool), natoms=jnp.full(B, N // B))
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
    monkeypatch.chdir(ROOT)  # the checkpoint's config names the data relative to the root
    run = tmp_path / "matpes_fixture"
    run.mkdir()
    shutil.copytree(RUN / "ckpt_best", run / "ckpt_best")
    shutil.copy(RUN / "ckpt_best.meta.json", run)
    cfg = json.loads((RUN / "ckpt_best.meta.json").read_text())["config"]

    jtest.main(["--checkpoint", "ckpt_best", "--run-dir", str(run), "--split", "test"])
    jax_eval = json.loads((run / "eval_test.json").read_text())
    sd = flax_to_state_dict(_jax_fixture_ema_params(str(run), cfg))
    out = test_matpes.evaluate_state_dict(cfg, sd, "test", "cpu", str(tmp_path))
    assert out["count"] == 8 and out["data"] == cfg["data_path"]
    tpu = json.loads((RUN / "eval_test.json").read_text())
    for k in ("energy_mae_mev_per_atom", "force_mae_mev_per_a"):
        v, jv = out[k], jax_eval[k]
        print(f"  {k}: port {v:.6g}  JAX CPU {jv:.6g} (rel {abs(v - jv) / jv:.1e})  "
              f"committed (TPU) {tpu[k]:.6g}  gap to TPU {abs(v - tpu[k]) / tpu[k]:.2e}")
        np.testing.assert_allclose(v, jv, rtol=1e-5, err_msg=k)
    assert json.loads((tmp_path / "eval_test.json").read_text()) == out
