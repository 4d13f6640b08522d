"""The MatPES CLI's pipeline mesh: ``--multihost --mesh data=1,pipe=2``
under 2 gloo processes trains one epoch of ``synthetic`` at a tiny width
and prints the JAX CLI's ``pipeline step:`` line; rank 0 writes a
checkpoint with the names and shapes of a one-process run's,
``Predictor.from_checkpoint`` serves it, and the run resumes from it
(re-sharded) for two more epochs.  In one process the CLI stops as the JAX
CLI does: on a config without ``scan_layers`` (``default``), on stress, and
on pipe with model."""

import numpy as np
import pytest
import torch

import torch_parallel_helpers as H
from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import train_matpes

TINY = dict(num_layers=2, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
            lmax=2, mmax=1, grid_resolution=None, edge_channels=8, num_rbf=16,
            max_train=8, max_val=4, batch_size=2, max_neighbors=8)
ENV = ("WORLD_SIZE", "ETQ_NUM_PROCESSES", "RANK", "ETQ_PROCESS_ID", "MASTER_ADDR",
       "MASTER_PORT", "ETQ_COORDINATOR", "ETQ_DIST_BACKEND")


def test_cli_data_1_pipe_2_trains_writes_and_resumes(tmp_path, capfd):
    run = tmp_path / "run"
    codes = H.spawn(H.cli_worker, 2, 2, H.free_port(), str(run), "data=1,pipe=2", TINY, 1)
    assert codes == [0, 0], f"rank exit codes {codes}"
    assert "pipeline step: data=1 pipe=2 (1 microbatches/step)" in capfd.readouterr().out
    steps = torch.load(run / "steps.pt")["steps"]
    assert steps == [4, 12]        # 8 structures / 2 a step; resumed, 2 more epochs
    for f in ("ckpt_best.pt", "ckpt_epoch_00000.pt", "ckpt_epoch_00001.pt", "losses.csv",
              "metrics.json"):
        assert (run / f).is_file(), f
    sd = torch.load(run / "ckpt_epoch_00001.pt", weights_only=True)
    model = train_matpes.build_model({**train_matpes.CONFIGS["synthetic"], **TINY}, False)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd["model"].items()} == want
    assert list(sd["model"]) == list(want)
    assert {k: tuple(v.shape) for k, v in sd["ema"].items()} == want
    assert sd["step"] == 12 and sd["optimizer"]["count"] == 12
    n_adam = len(sd["optimizer"]["adamw"]["state"])
    assert n_adam == sum(1 for _ in model.parameters())
    pred = Predictor.from_checkpoint(str(run), device="cpu")
    sample = train_matpes.load_data({**train_matpes.CONFIGS["synthetic"], **TINY})[1][0]
    out = pred.predict(sample.atomic_numbers, sample.pos, sample.cell)
    assert np.isfinite(out["energy"]) and np.isfinite(out["forces"]).all()


@pytest.mark.parametrize("config,mesh,overrides,stop", [
    ("default", "data=1,pipe=2", {}, "--mesh pipe= requires scan_layers=True"),
    ("synthetic", "data=1,pipe=2", {"regress_stress": True},
     "--mesh pipe= does not support stress yet"),
    ("synthetic", "model=2,pipe=2", {}, "pipe and model axes cannot be combined")],
    ids=["scan_layers", "stress", "model"])
def test_cli_pipe_stops_as_the_jax_cli(config, mesh, overrides, stop, tmp_path, monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    argv = ["--config", config, "--device", "cpu", "--mesh", mesh]
    with pytest.raises(SystemExit, match=stop):
        train_matpes.main(argv, dict(TINY, **overrides, run_dir=str(tmp_path / "run")))
    assert not (tmp_path / "run").exists()
