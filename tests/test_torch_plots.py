"""The port's QM9 statistics plots (utils/plots.py) against the JAX
package's.

* ``extended_stats`` equals the JAX package's on columns with NaNs, a
  constant column, two values and none.
* The target array the CLI loads, from a stats npz (``data``) and from a
  QM9 npz (``targets_raw``), equals the JAX package's bit for bit.
* The CLI's ``<prefix>_extended_stats.json`` equals the JSON the JAX
  package's suite writes of the same array (its ``extended_stats`` of each
  column, in its layout), and the suite writes the reference's figure set.
* Without matplotlib every plot function returns None and writes nothing.
Figure tests skip where matplotlib is absent.
"""

import glob
import json
import os

import numpy as np
import pytest

from equivarianttransformermpnn4quantumcomputations_tpu.utils import plots as jplots
from equivarianttransformermpnn4quantumcomputations_tpu_torch.data import prep as tprep
from equivarianttransformermpnn4quantumcomputations_tpu_torch.utils import plots as tplots


def _targets(n=200, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, 12)) * np.arange(1, 13) + np.arange(12)
    data[5, 3] = np.nan
    data[7] = np.nan          # an all-NaN row
    return data


COLUMNS = {
    "nan": np.array([1.0, 2.0, 3.0, 4.0, 100.0, np.nan]),
    "constant": np.full(9, 2.5),
    "two": np.array([0.0, 1.0]),
    "empty": np.array([np.nan, np.nan]),
    "normal": _targets()[:, 4],
}


@pytest.mark.parametrize("name", list(COLUMNS))
def test_extended_stats_matches_jax(name):
    assert tplots.extended_stats(COLUMNS[name]) == jplots.extended_stats(COLUMNS[name])


def test_target_array_loader_matches_jax(tmp_path):
    np.savez(tmp_path / "stats.npz", data=_targets())
    rng = np.random.default_rng(1)
    mols = [(rng.integers(1, 9, size=n), rng.normal(size=(n, 3)), rng.normal(size=12))
            for n in (3, 5, 4)]
    tprep.save_qm9_npz(mols, str(tmp_path / "qm9.npz"))
    for f in ("stats.npz", "qm9.npz"):
        got = tplots._load_target_array(str(tmp_path / f))
        want = jplots._load_target_array(str(tmp_path / f))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert tplots.QM9_PROPERTY_NAMES == jplots.QM9_PROPERTY_NAMES


def test_plot_cli_json_and_figures(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    np.savez(tmp_path / "stats.npz", data=_targets())
    tplots.main([str(tmp_path / "stats.npz"), "--out_dir", str(tmp_path / "out"), "--prefix",
                 "p", "--topk_pairs", "2"])
    out = tmp_path / "out" / "p_plots"
    assert f"All plots saved to: {out}" in capsys.readouterr().out
    with open(out / "p_extended_stats.json") as f:
        got = json.load(f)
    data = jplots._load_target_array(str(tmp_path / "stats.npz"))
    good = data[~np.isnan(data).all(axis=1)]
    names = list(jplots.QM9_PROPERTY_NAMES)
    want = {"property_names": names,
            "extended_stats": {n: jplots.extended_stats(good[:, j]) for j, n in enumerate(names)}}
    assert got == json.loads(json.dumps(want))
    files = sorted(os.path.basename(f) for f in glob.glob(str(out / "*")))
    for need in ("p_means_std.png", "p_median_iqr.png", "p_boxplots.png",
                 "p_violin_like.png", "p_corr_heatmap.png", "p_extended_stats.json"):
        assert need in files, need
    assert sum(f.startswith("hist_") for f in files) == 24
    assert sum(f.startswith("cdf_") for f in files) == 12
    assert sum("_pair_" in f for f in files) == 2


def test_quick_plots(tmp_path):
    pytest.importorskip("matplotlib")
    stats = tprep.compute_qm9_stats_arrays(np.abs(_targets(50, 2)[8:]),
                                           str(tmp_path / "stats.json"))
    assert stats["count"] == 42
    png = tplots.plot_qm9_stats(str(tmp_path / "stats.json"), str(tmp_path / "figs"))
    assert png == str(tmp_path / "figs" / "qm9_stats.png") and os.path.getsize(png) > 0
    with open(tmp_path / "losses.csv", "w") as f:
        f.write("epoch,train_loss,val_energy_mae_mev,note\n0,1.5,30,a\n1,1.2,25,b\n")
    out = str(tmp_path / "loss.png")
    assert tplots.plot_loss_curves(str(tmp_path / "losses.csv"), out) == out
    assert os.path.getsize(out) > 0


def test_without_matplotlib_every_plot_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.setattr(tplots, "_mpl", lambda: None)
    tprep.compute_qm9_stats_arrays(np.abs(_targets(50, 2)[8:]), str(tmp_path / "stats.json"))
    with open(tmp_path / "losses.csv", "w") as f:
        f.write("epoch,train_loss\n0,1.5\n")
    figs = tmp_path / "figs"
    assert tplots.plot_qm9_stats(str(tmp_path / "stats.json"), str(figs)) is None
    assert tplots.plot_loss_curves(str(tmp_path / "losses.csv"), str(figs / "l.png")) is None
    assert tplots.plot_qm9_full_stats(_targets(), str(figs)) is None
    assert not figs.exists()
    assert tplots.extended_stats(COLUMNS["nan"])["count"] == 5   # numpy either way
