"""The MatPES CLI's composite mesh under 2 gloo processes:
``--multihost --mesh data=1,model=2,sp`` trains one epoch of ``synthetic``
at a tiny width; rank 0 writes a checkpoint with the names and shapes of a
one-process run's, ``Predictor.from_checkpoint`` serves it, and the run
resumes from it (re-sharded) for two more epochs."""

import numpy as np
import torch

import torch_parallel_helpers as H
from equivarianttransformermpnn4quantumcomputations_tpu_torch.inference import Predictor
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import train_matpes

TINY = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
            lmax=2, mmax=1, grid_resolution=None, edge_channels=8, num_rbf=16,
            max_train=8, max_val=4, batch_size=2, max_neighbors=8)


def test_cli_data_1_model_2_sp_trains_writes_and_resumes(tmp_path):
    run = tmp_path / "run"
    codes = H.spawn(H.cli_worker, 2, 2, H.free_port(), str(run), "data=1,model=2,sp", TINY, 1)
    assert codes == [0, 0], f"rank exit codes {codes}"
    steps = torch.load(run / "steps.pt")["steps"]
    assert steps == [4, 12]        # 8 structures / 2 a step; resumed, 2 more epochs
    for f in ("ckpt_best.pt", "ckpt_epoch_00000.pt", "ckpt_epoch_00001.pt", "losses.csv",
              "metrics.json"):
        assert (run / f).is_file(), f
    sd = torch.load(run / "ckpt_epoch_00001.pt", weights_only=True)
    model = train_matpes.build_model({**train_matpes.CONFIGS["synthetic"], **TINY}, False)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd["model"].items()} == want
    assert {k: tuple(v.shape) for k, v in sd["ema"].items()} == want
    assert sd["step"] == 12 and sd["optimizer"]["count"] == 12
    pred = Predictor.from_checkpoint(str(run), device="cpu")
    sample = train_matpes.load_data({**train_matpes.CONFIGS["synthetic"], **TINY})[1][0]
    out = pred.predict(sample.atomic_numbers, sample.pos, sample.cell)
    assert np.isfinite(out["energy"]) and np.isfinite(out["forces"]).all()
