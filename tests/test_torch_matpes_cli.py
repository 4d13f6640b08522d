"""The MatPES CLIs of the port on the CPU: fixture training, its
checkpoint read by ``train/test_matpes.py`` and by
``Predictor.from_checkpoint``, the baseline config's stress term, the
clear stop of a config whose MatPES data is not on disk, and
``utils/guard_probe.py`` on a step the guard skips.

The Predictor's MAEs over the fixture's test structures equal the
evaluation CLI's (both denormalize with the checkpoint's statistics) to
1e-5 relative.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.matpes import load_matpes
from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import (
    test_matpes,
    train_matpes,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.trainer import (
    make_matpes_train_step,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import guard_probe

ROOT = Path(__file__).resolve().parents[1]
DATA_CONFIGS = ["default", "debug", "no-attn-norm", "phi-every-layer", "baseline"]


def test_fixture_cli_trains_and_its_checkpoint_is_read(tmp_path, monkeypatch):
    monkeypatch.chdir(ROOT)
    assert train_matpes.CONFIGS["fixture"]["run_dir"] == "runs/matpes_fixture_torch"
    run = tmp_path / "run"
    state = train_matpes.main(["--config", "fixture", "--device", "cpu", "--epochs", "1"],
                              overrides={"run_dir": str(run)})
    assert state.step == state.optimizer.count == 48 // 8
    out = test_matpes.main(["--checkpoint", str(run / "ckpt_best"), "--device", "cpu"])
    assert out["count"] == 8 and out["data"] == "tests/fixtures/train/matpes_train.json.gz"
    assert json.loads((run / "eval_test.json").read_text()) == out
    assert sorted(os.listdir(run)) == sorted(
        ["ckpt_best.pt", "ckpt_best.meta.json", "ckpt_epoch_00000.pt",
         "ckpt_epoch_00000.meta.json", "config.json", "losses.csv", "metrics.json",
         "eval_test.json"])

    pred = Predictor.from_checkpoint(str(run), device="cpu")
    _, _, test, _ = load_matpes("tests/fixtures/train/matpes_train.json.gz",
                                "tests/fixtures/train/matpes_split_train.json.gz",
                                normalize_energy=False)
    got = pred.predict_batch([dict(atomic_numbers=test[i].atomic_numbers,
                                   positions=test[i].pos, cell=test[i].cell)
                              for i in range(len(test))])
    e_mae = np.mean([abs(got["energy_per_atom"][i] - test[i].energy) for i in range(8)])
    f_mae = np.mean(np.concatenate([np.abs(got["forces"][i] - test[i].forces).ravel()
                                    for i in range(8)]))
    np.testing.assert_allclose(1e3 * e_mae, out["energy_mae_mev_per_atom"], rtol=1e-5)
    np.testing.assert_allclose(1e3 * f_mae, out["force_mae_mev_per_a"], rtol=1e-5)


def test_baseline_cli_trains_with_stress(tmp_path, monkeypatch, capsys):
    """``--config baseline`` (gata off, stress at w_stress 0.1) on the
    fixture's data at the fixture's widths: the stress term is in the loss."""
    monkeypatch.chdir(ROOT)
    fixture = train_matpes.CONFIGS["fixture"]
    small = {k: fixture[k] for k in (
        "data_path", "split_path", "cache_dir", "batch_size", "num_layers", "sphere_channels",
        "attn_hidden_channels", "num_heads", "attn_alpha_channels", "attn_value_channels",
        "ffn_hidden_channels", "lmax", "mmax", "grid_resolution", "edge_channels", "num_rbf",
        "cutoff", "max_neighbors")}
    state = train_matpes.main(
        ["--config", "baseline", "--device", "cpu", "--epochs", "1"],
        overrides={**small, "max_train": 16, "mixed_precision": False,
                   "run_dir": str(tmp_path / "run")})
    assert state.step == 2 and not state.model.backbone.gata
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("epoch 0"))
    assert "train_stress_l1=" in line
    assert "train_stress_l1" in (tmp_path / "run" / "losses.csv").read_text().splitlines()[0]


@pytest.mark.parametrize("name", DATA_CONFIGS)
def test_cli_stops_naming_the_missing_data(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="datasets/MatPES/MatPES-PBE-2025.1.json.gz"):
        train_matpes.main(["--config", name, "--device", "cpu"])
    assert not os.listdir(tmp_path)


def test_guard_probe_reports_the_skipped_step(tmp_path, monkeypatch, capsys):
    """utils/guard_probe.py on the fixture config: a learning rate that
    blows the weights up makes the guard skip a step, and the probe names
    the non-finite gradients on the device and on the CPU."""
    fixture = train_matpes.CONFIGS["fixture"]
    monkeypatch.setitem(train_matpes.CONFIGS, "fixture", {
        **fixture, "epochs": 1, "warmup_epochs": 0, "lr": 1e30,
        **{k: str(ROOT / fixture[k]) for k in ("data_path", "split_path")}})
    monkeypatch.chdir(tmp_path)
    assert guard_probe.main(["--config", "fixture", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "the guard skipped step" in out
    assert "cpu: loss" in out and "parameters with a non-finite gradient" in out
    assert train_matpes.make_matpes_train_step is make_matpes_train_step
