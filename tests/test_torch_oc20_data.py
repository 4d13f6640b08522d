"""OC20 data, the CLIs and the MatPES CLI's model build.

* ``OC20Dataset`` (the port's extxyz reader and the OCP normalization)
  against the JAX package's on extxyz files this test writes, with tags,
  a logical column and a blank line between frames; the collated batches
  (``fixed`` included) against the JAX package's collate.
* ``train_oc20 --config synthetic --device cpu`` then ``test_oc20`` on its
  checkpoint, end to end.
* The MatPES CLI builds from every model key of its config, and every
  config of the JAX CLI builds its model.
"""

import json

import numpy as np
import pytest
import torch

from equivarianttransformermpnn4quantumcomputations_tpu.data import graph as jgraph
from equivarianttransformermpnn4quantumcomputations_tpu.data import oc20 as joc20
from equivarianttransformermpnn4quantumcomputations_tpu_torch.configs import matpes as mp_cfg
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import graph as tgraph
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import oc20 as toc20
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data.periodic import SYMBOLS
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train import test_oc20, train_oc20
from equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_matpes import (
    CONFIGS,
    build_model,
)


def _write_extxyz(path, frames, blank_between=False):
    """frames: list of (symbols, pos, cell, energy, forces, tags)."""
    with open(path, "w") as f:
        for symbols, pos, cell, energy, forces, tags in frames:
            f.write(f"{len(symbols)}\n")
            lat = " ".join(f"{v:.8f}" for v in np.asarray(cell).ravel())
            f.write(f'Lattice="{lat}" Properties=species:S:1:pos:R:3:move_mask:L:1:'
                    f'tags:I:1:forces:R:3 energy={energy:.8f} pbc="T T T"\n')
            for s, p, fr, t in zip(symbols, pos, forces, tags):
                f.write(f"{s} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} {'T' if t else 'F'} {int(t)} "
                        f"{fr[0]:.8f} {fr[1]:.8f} {fr[2]:.8f}\n")
            if blank_between:
                f.write("\n")


def _frame(rng, n):
    symbols = [SYMBOLS[int(z)] for z in rng.integers(1, 80, size=n)]
    cell = np.eye(3) * 7.0 + rng.normal(size=(3, 3)) * 0.1
    pos = rng.uniform(0, 1, size=(n, 3)) @ cell
    return (symbols, pos, cell, float(rng.normal() * 10), rng.normal(size=(n, 3)),
            rng.integers(0, 3, size=n))


@pytest.fixture(scope="module")
def oc20_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("oc20")
    rng = np.random.default_rng(0)
    _write_extxyz(d / "a.extxyz", [_frame(rng, n) for n in (6, 9, 7)], blank_between=True)
    _write_extxyz(d / "b.extxyz", [_frame(rng, n) for n in (8, 5)])
    return d


@pytest.mark.parametrize("normalize", [True, False])
def test_oc20_dataset_matches_jax(oc20_dir, normalize):
    dj = joc20.OC20Dataset(str(oc20_dir), normalize=normalize)
    dt = toc20.OC20Dataset(str(oc20_dir), normalize=normalize)
    assert len(dt) == len(dj) == 5
    np.testing.assert_array_equal(dt.cumsum, dj.cumsum)
    for i in range(len(dt)):
        a, b = dt[i], dj[i]
        np.testing.assert_array_equal(a.atomic_numbers, b.atomic_numbers)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.cell, b.cell)
        np.testing.assert_array_equal(a.forces, b.forces)
        np.testing.assert_array_equal(a.fixed, b.fixed)
        assert a.pbc == b.pbc and a.energy == b.energy
    assert toc20.OC20_ENERGY_MEAN == joc20.OC20_ENERGY_MEAN
    assert toc20.OC20_ENERGY_STD == joc20.OC20_ENERGY_STD


def test_oc20_quick_init_matches_jax(oc20_dir):
    dj = joc20.OC20Dataset(str(oc20_dir), quick_init=True, quick_init_sample=1)
    dt = toc20.OC20Dataset(str(oc20_dir), quick_init=True, quick_init_sample=1)
    assert len(dt) == len(dj)
    last = len(dt) - 1  # past the true end of b.extxyz: its last frame
    np.testing.assert_array_equal(dt[last].pos, dj[last].pos)


def test_oc20_collate_matches_jax(oc20_dir, monkeypatch):
    """Fixed-degree batches of the same frames, ``fixed`` included (the JAX
    package's numpy neighbour search, which the port copies)."""
    monkeypatch.setattr(jgraph, "USE_NATIVE", False)
    dt = toc20.OC20Dataset(str(oc20_dir))
    samples = [dt[i] for i in range(4)]
    pt = tgraph.collate(samples, 6.0, 12, 48, 48 * 12, fixed_degree=True)
    pj = jgraph.collate(samples, 6.0, 12, 48, 48 * 12, fixed_degree=True)
    dj = pj.asdict()
    # no loss reads ``fixed`` yet, so the port keeps it off the device dict
    assert dj.keys() - {"fixed"} == pt.asdict().keys()
    for k, v in pt.asdict().items():
        np.testing.assert_array_equal(v, dj[k], err_msg=k)
    np.testing.assert_array_equal(pt.fixed, pj.fixed)
    assert pt.fixed.sum() > 0


def test_oc20_cli_trains_then_evaluates(tmp_path):
    """The synthetic config end to end on the CPU: train, checkpoint, then
    the evaluation CLI on the best checkpoint."""
    run_dir = tmp_path / "run"
    state = train_oc20.main(["--config", "synthetic", "--device", "cpu", "--run-dir",
                             str(run_dir)])
    assert state.step == 2 * 4  # 2 epochs of 16 crystals in batches of 4
    assert (run_dir / "ckpt_best.pt").is_file()
    meta = json.loads((run_dir / "ckpt_best.meta.json").read_text())
    assert meta["config"]["wigner_rep"] == "factored"
    out = test_oc20.main(["--checkpoint", str(run_dir / "ckpt_best"), "--device", "cpu"])
    assert out["n_frames"] == 16 and out["data"] == "synthetic"
    assert np.isfinite(out["energy_mae_mev"]) and np.isfinite(out["force_mae_mev_per_a"])
    assert json.loads((run_dir / "eval_oc20_val.json").read_text()) == out


def test_oc20_cli_reads_extxyz(oc20_dir, tmp_path):
    """The debug config's data path: extxyz frames through the loader."""
    overrides = dict(data_path=str(oc20_dir), val_path=None, batch_size=2, epochs=1,
                     num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
                     attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=8,
                     edge_channels=8, num_rbf=8, cutoff=4.0, max_neighbors=8,
                     run_dir=str(tmp_path / "run"))
    state = train_oc20.main(["--config", "debug", "--device", "cpu"], overrides)
    assert state.step == 2 and state.model.backbone.lmax == 3
    out = test_oc20.main(["--checkpoint", str(tmp_path / "run" / "ckpt_best"),
                          "--data-path", str(oc20_dir), "--device", "cpu"])
    assert out["data"] == str(oc20_dir) and out["n_frames"] == 5


_SMALL = dict(num_layers=1, sphere_channels=8, attn_hidden_channels=8, num_heads=2,
              attn_alpha_channels=4, attn_value_channels=4, ffn_hidden_channels=8,
              edge_channels=8, num_rbf=8, lmax=2, mmax=1, grid_resolution=None)


@pytest.mark.parametrize("gata", [True, False])
def test_matpes_build_model_reads_every_key(gata):
    model = build_model({**mp_cfg.synthetic, **_SMALL, "gata": gata}, False)
    assert model.backbone.gata == gata
    assert hasattr(model.backbone, "h_proj") == gata
    assert model.backbone.wigner_rep == mp_cfg.synthetic["wigner_rep"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matpes_build_model_builds_every_config(name):
    """Every config of the JAX CLI builds its model, with its options (one
    layer: the widths are the config's own)."""
    cfg = {**CONFIGS[name], "num_layers": 1}
    model = build_model(cfg, bool(cfg["mixed_precision"]))
    bb = model.backbone
    assert bb.gata == cfg["gata"] and (bb.lmax, bb.mmax) == (cfg["lmax"], cfg["mmax"])
    assert bb.compute_dtype == (torch.bfloat16 if cfg["mixed_precision"] else torch.float32)
    ga = bb.blocks[0].ga
    assert ga.normalize_attn_output == cfg["normalize_attn_output"]
    assert hasattr(ga, "value_act") == cfg["gata"]
    if cfg["gata"]:
        assert ga.value_act.use_phi == cfg["use_phi_every_layer"]
        assert hasattr(ga.value_act, "phi_proj") == cfg["use_phi_every_layer"]
    assert cfg["regress_stress"] == (cfg["w_stress"] > 0.0) == (name == "baseline")
    assert not cfg["run_dir"].rstrip("/").endswith(("matpes_fixture",
                                                    "matpes_synth_convergence"))


def test_matpes_build_model_needs_every_key():
    cfg = dict(mp_cfg.synthetic)
    del cfg["gata"]
    with pytest.raises(KeyError, match="gata"):
        build_model(cfg, False)
