"""Multi-process set-up without a second process: the port's
parallel/multihost.py, the loader's per-rank shards against the JAX
package's, rank-0 writes, and the MatPES CLI's --multihost / --mesh in one
process on the CPU."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from equivarianttransformermpnn4quantumcomputations_tpu.data import loader as jloader
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import loader as tloader
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import synthetic as tsynth
from equivarianttransformermpnn4quantumcomputations_tpu_torch.parallel import multihost
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import train_matpes, train_oc20
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.checkpoint import (
    CheckpointManager,
)
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.logging import RunLogger

ENV = ("WORLD_SIZE", "ETQ_NUM_PROCESSES", "RANK", "ETQ_PROCESS_ID", "MASTER_ADDR",
       "MASTER_PORT", "ETQ_COORDINATOR", "ETQ_DIST_BACKEND")
TINY = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
            attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=16,
            lmax=2, mmax=1, grid_resolution=None, edge_channels=8, num_rbf=16,
            max_train=8, max_val=4, batch_size=2, epochs=1, max_neighbors=8)


@pytest.mark.parametrize("world", [None, "1"], ids=["unset", "world_size_1"])
def test_initialize_is_a_no_op_for_one_process(world, monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    if world is not None:
        monkeypatch.setenv("WORLD_SIZE", world)
        monkeypatch.setenv("RANK", "0")
    assert multihost.initialize_from_env(device="cpu") is False
    assert not dist.is_initialized()
    assert (multihost.process_index(), multihost.process_count(),
            multihost.is_primary()) == (0, 1, True)


def test_host_shard_partitions_the_data():
    n = 23
    for shards in (1, 2, 3, 4):
        parts = [np.arange(n)[multihost.host_shard(n, shards, k)] for k in range(shards)]
        assert sorted(np.concatenate(parts).tolist()) == list(range(n))
        assert max(map(len, parts)) - min(map(len, parts)) <= 1
    assert multihost.host_shard(n) == slice(0, n, 1)   # one process: everything


@pytest.mark.parametrize("num_shards", [2, 3])
def test_loader_shards_equal_the_jax_loader(num_shards):
    ds = tsynth.SyntheticCrystals(n_samples=23, n_atoms=4, seed=0)
    kw = dict(batch_size=3, cutoff=4.0, max_neighbors=8, n_pad=12, e_pad=96, shuffle=True,
              seed=5, prefetch=0, num_shards=num_shards)
    seen = []
    for shard in range(num_shards):
        t = tloader.PaddedLoader(ds, shard_id=shard, uniform=True, fixed_degree=True, **kw)
        j = jloader.PaddedLoader(ds, shard_id=shard, uniform=True, fixed_degree=True, **kw)
        for loader in (t, j):
            loader.set_epoch(3)
        got, want = list(t._index_batches()), list(j._index_batches())
        assert len(t) == len(j) == len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        seen += [i for b in got for i in b]
    assert len(seen) == len(set(seen))          # the shards are disjoint


def test_non_primary_logger_and_checkpoints_write_nothing(tmp_path):
    run = tmp_path / "run"
    logger = RunLogger(str(run), {"a": 1}, primary=False)
    logger.log_epoch(0, {"loss": 1.0})
    logger.update_metrics(best=1.0)
    logger.finalize()
    ckpt = CheckpointManager(str(run), {"a": 1}, primary=False)

    class _State:
        def state_dict(self):
            return {"w": torch.zeros(3)}

    ckpt.save_best(_State(), {"epoch": 0})
    ckpt.save_periodic(0, _State())
    ckpt.save("ckpt_emergency", _State())
    assert not run.exists()


def test_matpes_cli_multihost_data_parallel_in_one_process(tmp_path, monkeypatch):
    """--multihost without a process group is one process; --mesh data=2
    runs both micro-batches of each step in it."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    run = tmp_path / "run"
    state = train_matpes.main(["--config", "synthetic", "--device", "cpu", "--multihost",
                               "--mesh", "data=2"], dict(TINY, run_dir=str(run)))
    assert not dist.is_initialized()
    assert state.step == 2 and state.optimizer.count == 2    # 4 batches, 2 a step
    for f in ("ckpt_best.pt", "ckpt_epoch_00000.pt", "losses.csv", "metrics.json"):
        assert (run / f).is_file(), f


@pytest.mark.parametrize("mesh,stop", [
    ("data=2,model=2", "model=2 needs a multiple of 2 processes"),
    ("data=2,pipe=2", "pipe=2 needs a multiple of 2 processes"),
    ("data=2,sp", None)], ids=["data=2,model=2", "data=2,pipe=2", "data=2,sp"])
def test_unported_mesh_axes_stop(mesh, stop, tmp_path, monkeypatch):
    """One process: model=2 and pipe=2 stop for want of processes (the
    pipeline trains at 2 processes: tests/test_torch_pipeline_cli.py), and
    sp at model=1 trains data-parallel."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    argv = ["--config", "synthetic", "--device", "cpu", "--mesh", mesh]
    if stop is None:
        state = train_matpes.main(argv, dict(TINY, run_dir=str(tmp_path / "run")))
        assert state.step == 2 and state.mesh is None   # 4 batches, 2 a step
        return
    with pytest.raises(SystemExit, match=stop):
        train_matpes.main(argv, dict(TINY, run_dir=str(tmp_path / "run")))
    assert not (tmp_path / "run").exists()


@pytest.mark.parametrize("mesh,axes", [("data=4", (4, 1, 1, False)),
                                       ("data=2,model=1", (2, 1, 1, False)),
                                       ("data=2, pipe=1", (2, 1, 1, False)), ("data=x", None),
                                       ("model=2", (1, 2, 1, False)), ("data=0", None),
                                       ("data=2,pipe=2,sp", (2, 1, 2, True)),
                                       ("model=2,pipe=2", None), ("pipe=0", None)],
                         ids=["data=4-4", "data=2,model=1-2", "data=2, pipe=1-2", "data=x-None",
                              "model=2-None", "data=0-None", "data=2,pipe=2,sp",
                              "model=2,pipe=2-None", "pipe=0-None"])
def test_parse_mesh(mesh, axes):
    """The axes (data, model, pipe, sp); pipe with model stops, as in the
    JAX CLI."""
    if axes is None:
        with pytest.raises(SystemExit):
            train_matpes.parse_mesh(mesh)
    else:
        assert train_matpes.parse_mesh(mesh) == dict(zip(("data", "model", "pipe", "sp"),
                                                         axes))


def test_oc20_data_parallel_takes_the_plain_step_in_one_process(tmp_path, monkeypatch):
    """As the JAX CLI on one device: --data-parallel with one process trains
    exactly as the plain step does."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    tiny = {k: v for k, v in TINY.items() if k not in ("grid_resolution", "max_train",
                                                       "max_val")}
    tiny.update(n_samples=8, n_atoms=5, lmax=2, mmax=1)
    argv = ["--config", "synthetic", "--device", "cpu"]
    plain = train_oc20.main(argv, dict(tiny, run_dir=str(tmp_path / "plain")))
    dp = train_oc20.main(argv + ["--multihost", "--data-parallel"],
                         dict(tiny, run_dir=str(tmp_path / "dp")))
    assert plain.step == dp.step == 4
    for (k, a), b in zip(plain.model.named_parameters(), dp.model.parameters()):
        assert torch.equal(a, b), k
