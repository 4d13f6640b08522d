"""The ragged ``Predictor`` and the evaluation CLIs' flags: the port against
the JAX package on the CPU.

A mixed-size request (one structure of 14 atoms and four of 3 to 5, made by
numpy from a seed), molecular and periodic, goes through the JAX package's
``Predictor`` and the port's on the same converted weights (2 layers, 16
channels, lmax 2 / mmax 1): the pads are JAX's (a multiple of 16 above the
atom count, of 128 above the edge count), the batch equals JAX's collate
array for array, energies agree to 1e-5 relative and each structure's
forces to 1e-4 of the largest.  The evaluation CLIs: ``test_oc20 --split X
--run-dir D`` writes ``D/eval_oc20_X.json`` (the JAX CLI's name) and
``test_qm9 --run-dir D`` reads and writes ``D``.
"""

import json
import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import torch_variant_helpers as V
from equivarianttransformermpnn4quantumcomputations_tpu import inference as jinference
from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.models.matpes import (
    EquiformerV2MatPES as JaxMatPES,
)
from equivarianttransformermpnn4quantumcomputations_tpu.utils import flags
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.loader import bucket
from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.models.matpes import (
    EquiformerV2MatPES,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import (
    test_oc20,
    test_qm9,
    train_oc20,
    train_qm9,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.convert import (
    flax_to_state_dict,
)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(num_layers=2, sphere_channels=16, attn_hidden_channels=16, num_heads=2,
           attn_alpha_channels=8, attn_value_channels=8, ffn_hidden_channels=32,
           lmax=2, mmax=1, grid_resolution=None, edge_channels=16, num_rbf=32,
           max_num_elements=20, cutoff=5.0, alpha_drop=0.0, drop_path_rate=0.0)
CUTOFF, MAX_NEIGHBORS = 5.0, 6


def _request(periodic: bool, seed: int = 0, sizes=(14, 3, 5, 4, 3)):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        cell = (np.eye(3) * 4.5 + rng.normal(size=(3, 3)) * 0.1).astype(np.float32)
        pos = (rng.uniform(0, 1, size=(n, 3)) @ cell).astype(np.float32)
        out.append(dict(atomic_numbers=rng.integers(1, 10, size=n).astype(np.int32),
                        positions=pos, cell=cell if periodic else None))
    return out


@pytest.mark.parametrize("periodic", [False, True], ids=["molecular", "periodic"])
def test_ragged_predictor_matches_jax(monkeypatch, periodic):
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    structs = _request(periodic)
    jm = JaxMatPES(**CFG, wigner_rep="dense", remat=False)
    port = EquiformerV2MatPES(**CFG)
    pb = Predictor(port, port.state_dict(), CUTOFF, MAX_NEIGHBORS, device="cpu").collate(structs)
    # JAX's pads and JAX's ragged collate of the same request
    n_tot = sum(len(s["atomic_numbers"]) for s in structs)
    assert pb.pos.shape[0] == jinference._bucket(n_tot + 1)
    assert pb.edge_src.shape[0] == jinference._bucket(int(pb.edge_mask.sum()) + 1, 128)
    samples = [jgraph.GraphSample(s["atomic_numbers"], s["positions"], s["cell"],
                                  s["cell"] is not None) for s in structs]
    want = jgraph.collate(samples, CUTOFF, MAX_NEIGHBORS, pb.pos.shape[0], pb.edge_src.shape[0])
    for k, v in pb.asdict().items():
        np.testing.assert_array_equal(v, want.asdict()[k], err_msg=k)
    jb = {k: jnp.asarray(v) for k, v in want.asdict().items()}
    params = V.random_flax_params(jm, jb, 3)
    with flags.override(wigner="dense"):
        ref = jinference.Predictor(jm, params, CUTOFF, MAX_NEIGHBORS).predict_batch(structs)
    out = Predictor(port, flax_to_state_dict(params), CUTOFF, MAX_NEIGHBORS,
                    device="cpu").predict_batch(structs)
    np.testing.assert_allclose(out["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(out["energy_per_atom"], ref["energy_per_atom"], rtol=1e-5)
    assert [f.shape for f in out["forces"]] == [f.shape for f in ref["forces"]]
    for got, f in zip(out["forces"], ref["forces"]):
        f = np.asarray(f)
        np.testing.assert_allclose(got, f, rtol=0, atol=1e-4 * np.abs(f).max())


@pytest.mark.parametrize("quantum", [16, 128])
def test_request_bucket_matches_jax(quantum):
    # the serving request's pad rule, exact: every count from 0 to 4 quanta
    for n in range(4 * quantum + 2):
        assert bucket(n, quantum) == jinference._bucket(n, quantum), n


def test_predictor_refuses_another_layout():
    model = EquiformerV2MatPES(**CFG, uniform_blocks=True, fixed_degree=True)
    with pytest.raises(ValueError, match="ragged"):
        Predictor(model, model.state_dict(), CUTOFF, MAX_NEIGHBORS, device="cpu")


@pytest.mark.parametrize("split", [None, "test"], ids=["default", "test"])
def test_oc20_eval_cli_split_and_run_dir(tmp_path, split):
    """``--split`` names the output only (the JAX CLI's default is val);
    ``--run-dir`` is where the checkpoint is read and the result written."""
    tiny = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
                attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
                lmax=2, mmax=1, edge_channels=8, num_rbf=16, batch_size=2, epochs=1,
                max_neighbors=8, n_samples=4, n_atoms=5, run_dir=str(tmp_path / "train"))
    train_oc20.main(["--config", "synthetic", "--device", "cpu"], tiny)
    run = tmp_path / "elsewhere"
    os.rename(tmp_path / "train", run)
    argv = ["--checkpoint", "ckpt_best", "--run-dir", str(run), "--device", "cpu"]
    out = test_oc20.main(argv + ([] if split is None else ["--split", split]))
    name = f"eval_oc20_{split or 'val'}.json"
    assert json.loads((run / name).read_text()) == json.loads(json.dumps(out))
    assert out["split"] == (split or "val") and np.isfinite(out["energy_mae_mev"])
    assert not (run / "eval_oc20.json").exists()


@pytest.fixture(scope="module")
def qm9_run(tmp_path_factory):
    """One epoch of a 1-layer QM9 fixture run: the eval CLI tests' checkpoint."""
    run = tmp_path_factory.mktemp("qm9") / "train"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)  # the fixture config names its db relative to the root
        train_qm9.main(["--config", "fixture", "--device", "cpu", "--epochs", "1"],
                       overrides=dict(run_dir=str(run), num_layers=1, sphere_channels=8,
                                      attn_hidden_channels=8, ffn_hidden_channels=16,
                                      edge_channels=8, num_rbf=16, lmax=2, mmax=1,
                                      grid_resolution=None))
    return run


def test_qm9_eval_cli_run_dir(tmp_path, monkeypatch, qm9_run):
    """``test_qm9 --run-dir D --checkpoint NAME`` reads D/NAME and writes there."""
    monkeypatch.chdir(ROOT)
    run = tmp_path / "elsewhere"
    shutil.copytree(qm9_run, run)
    out = test_qm9.main(["--checkpoint", "ckpt_best", "--run-dir", str(run), "--device", "cpu"])
    assert out["count"] == 8 and all(np.isfinite(v) for v in out["mae"].values())
    assert json.loads((run / "eval_test.json").read_text())["mae"] == out["mae"]
    assert np.load(run / "predictions.npy").shape == (8, 12)


def test_qm9_eval_cli_accepts_use_ema(tmp_path, monkeypatch, qm9_run):
    """``test_qm9 --use-ema`` parses, as in the JAX CLI (a ``store_true`` flag
    that defaults to True), and changes nothing: the EMA weights either way."""
    monkeypatch.chdir(ROOT)
    run = tmp_path / "run"
    shutil.copytree(qm9_run, run)
    argv = ["--checkpoint", str(run / "ckpt_best"), "--device", "cpu"]
    plain = test_qm9.main(argv)
    flagged = test_qm9.main(argv + ["--use-ema"])
    assert flagged == plain and flagged["count"] == 8
