"""QM9 dataset-statistics plots (the port's own copy of the JAX package's
utils/plots.py, after the reference's
datasets/QM9/DatasetStastics/plotstatistics.py).

* Quick panels from the stats JSON and a run's ``losses.csv``
  (``plot_qm9_stats``, ``plot_loss_curves``).
* The full per-property suite on a raw [n, 12] target array in paper units
  (``plot_qm9_full_stats``): means +- std, median and IQR, boxplots, per
  property a histogram, a log-y histogram and the CDF, a violin-like panel,
  the correlation heatmap, the top-k correlated pairs' scatters, and
  ``<prefix>_extended_stats.json`` (``extended_stats`` of each column: the
  reference's fields, plotstatistics.py:72-105).

CLI (the target array from a stats npz's ``data`` or a QM9 npz's
``targets_raw``, data/prep.py:save_qm9_npz)::

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.plots \\
        qm9.npz --out_dir stats_plots --prefix qm9 --topk_pairs 6

The statistics are numpy; without matplotlib every plot is skipped and the
functions return None (the full suite writes nothing then, as in the JAX
package).
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

__all__ = ["QM9_PROPERTY_NAMES", "plot_qm9_stats", "plot_loss_curves", "extended_stats",
           "plot_qm9_full_stats", "main"]

# paper-order display names (reference plotstatistics.py:19-20)
QM9_PROPERTY_NAMES = ["alpha", "gap", "homo", "lumo", "mu", "Cv", "G", "H", "r2", "U", "U0",
                      "zpve"]


def _mpl():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    return plt


def plot_qm9_stats(stats_json: str, out_dir: str):
    """One panel a property: a normal curve of the stats JSON's mean and std
    over its p1-p99 range.  Returns the png's path (None without
    matplotlib)."""
    plt = _mpl()
    if plt is None:
        return None
    with open(stats_json) as f:
        j = json.load(f)
    stats = j.get("stats", j)
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(3, 4, figsize=(16, 10))
    for ax, name in zip(axes.flat, stats):
        s = stats[name]
        mean, std = s["mean"], s["std"]
        xs = np.linspace(s.get("p1", mean - 3 * std), s.get("p99", mean + 3 * std), 200)
        ax.plot(xs, np.exp(-0.5 * ((xs - mean) / max(std, 1e-9)) ** 2))
        ax.axvline(mean, ls="--", lw=0.8)
        ax.set_title(f"{name}\nmean={mean:.3g} std={std:.3g}", fontsize=8)
    fig.tight_layout()
    path = os.path.join(out_dir, "qm9_stats.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_loss_curves(losses_csv: str, out_path: str):
    """Every finite numeric column of ``losses.csv`` against the epoch
    (symlog y).  Returns ``out_path`` (None without matplotlib or rows)."""
    plt = _mpl()
    if plt is None:
        return None
    with open(losses_csv) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    epochs = [float(r["epoch"]) for r in rows]
    fig, ax = plt.subplots(figsize=(8, 5))
    for k in (k for k in rows[0] if k != "epoch"):
        try:
            ys = [float(r[k]) for r in rows]
        except ValueError:
            continue
        if all(np.isfinite(ys)):
            ax.plot(epochs, ys, label=k)
    ax.set_xlabel("epoch")
    ax.legend(fontsize=8)
    ax.set_yscale("symlog")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def extended_stats(col: np.ndarray) -> dict:
    """The reference's statistics of one column, NaNs left out (counted in
    ``nan_count``): count, mean, std (ddof 1), min, max, median, p25, p75,
    skewness, Fisher kurtosis, zeros; {} for an empty column."""
    col = np.asarray(col, np.float64)
    nan_count = int(np.isnan(col).sum())
    col = col[~np.isnan(col)]
    n = col.size
    if n == 0:
        return {}
    mean = float(col.mean())
    std = float(col.std(ddof=1)) if n > 1 else 0.0
    if std == 0 or n < 3:
        skew, kurt = 0.0, -3.0
    else:
        z = (col - mean) / std
        skew, kurt = float(np.mean(z ** 3)), float(np.mean(z ** 4)) - 3.0
    return {"count": int(n), "mean": mean, "std": std, "min": float(col.min()),
            "max": float(col.max()), "median": float(np.median(col)),
            "p25": float(np.percentile(col, 25.0)), "p75": float(np.percentile(col, 75.0)),
            "skewness": skew, "kurtosis": kurt, "zeros": int((col == 0).sum()),
            "nan_count": nan_count}


def _save(plt, path: str) -> None:
    plt.tight_layout()
    plt.savefig(path, dpi=200)
    plt.close()


def _per_property(plt, outdir: str, j: int, name: str, col: np.ndarray, bins: int) -> None:
    """Histogram, log-y histogram and CDF of one property."""
    plt.figure(figsize=(8, 4))
    plt.hist(col, bins=bins)
    plt.title(f"Histogram: {name}")
    plt.xlabel("value")
    plt.ylabel("count")
    _save(plt, os.path.join(outdir, f"hist_{j}_{name}.png"))

    counts, edges = np.histogram(col, bins=bins)
    plt.figure(figsize=(8, 4))
    plt.bar((edges[:-1] + edges[1:]) / 2, counts, width=edges[1] - edges[0])
    plt.yscale("log")
    plt.title(f"Histogram (log-y): {name}")
    plt.xlabel("value")
    plt.ylabel("count (log scale)")
    _save(plt, os.path.join(outdir, f"hist_logy_{j}_{name}.png"))

    ordered = np.sort(col)
    plt.figure(figsize=(8, 4))
    plt.plot(ordered, np.arange(1, ordered.size + 1) / float(ordered.size))
    plt.title(f"CDF: {name}")
    plt.xlabel("value")
    plt.ylabel("cumulative prob")
    _save(plt, os.path.join(outdir, f"cdf_{j}_{name}.png"))


def plot_qm9_full_stats(data: np.ndarray, out_dir: str, names: list | None = None,
                        prefix: str = "qm9", topk_pairs: int = 6, bins: int = 100,
                        sample_limit: int = 100_000, seed: int = 0):
    """The reference's full statistics suite of a raw [n, 12] target array
    (paper units) into ``out_dir/<prefix>_plots/`` (module doc); rows that
    are all NaN are left out.  Returns that directory (None without
    matplotlib)."""
    plt = _mpl()
    if plt is None:
        return None
    rng = np.random.default_rng(seed)
    data = np.asarray(data, np.float64)
    names = list(names) if names is not None else list(QM9_PROPERTY_NAMES)
    good = data[~np.isnan(data).all(axis=1)]
    outdir = os.path.join(out_dir, f"{prefix}_plots")
    os.makedirs(outdir, exist_ok=True)
    x = np.arange(len(names))

    plt.figure(figsize=(12, 5))
    plt.errorbar(x, np.nanmean(good, axis=0), yerr=np.nanstd(good, axis=0, ddof=1), fmt="o",
                 capsize=5, markersize=6)
    plt.xticks(x, names, rotation=45, ha="right")
    plt.title("QM9 target means ± std (paper units)")
    _save(plt, os.path.join(outdir, f"{prefix}_means_std.png"))

    medians = np.nanmedian(good, axis=0)
    p25, p75 = np.nanpercentile(good, 25, axis=0), np.nanpercentile(good, 75, axis=0)
    plt.figure(figsize=(12, 6))
    for i in range(len(names)):
        plt.plot([i, i], [p25[i], p75[i]], linewidth=6)
        plt.plot(i, medians[i], marker="o", markersize=6, markeredgecolor="k")
    plt.xticks(x, names, rotation=45, ha="right")
    plt.title("QM9 target median and IQR (p25-p75)")
    _save(plt, os.path.join(outdir, f"{prefix}_median_iqr.png"))

    cols = [good[:, j][~np.isnan(good[:, j])] for j in range(good.shape[1])]
    plt.figure(figsize=(12, 6))
    plt.boxplot(cols, tick_labels=names, showfliers=True)
    plt.xticks(rotation=45, ha="right")
    plt.title("QM9 property boxplots")
    _save(plt, os.path.join(outdir, f"{prefix}_boxplots.png"))

    for j, name in enumerate(names):
        if cols[j].size:
            col = (rng.choice(cols[j], sample_limit, replace=False)
                   if cols[j].size > sample_limit else cols[j])
            _per_property(plt, outdir, j, name, col, bins)

    plt.figure(figsize=(12, 6))
    ax = plt.gca()
    for j, col in enumerate(cols):
        if col.size == 0:
            continue
        sample = rng.choice(col, 2000, replace=False) if col.size > 2000 else col
        ax.scatter(rng.normal(loc=j, scale=0.06, size=sample.size), sample, alpha=0.3, s=6)
        med, q1, q3 = np.median(col), np.percentile(col, 25), np.percentile(col, 75)
        ax.plot([j - 0.15, j + 0.15], [med, med], color="k", linewidth=3)
        ax.add_patch(plt.Rectangle((j - 0.15, q1), 0.3, q3 - q1, alpha=0.2))
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45, ha="right")
    ax.set_title("Violin-like (sampled points + IQR + median)")
    _save(plt, os.path.join(outdir, f"{prefix}_violin_like.png"))

    # Pearson correlations, NaNs imputed with column means (as the reference)
    col_ok = ~np.isnan(good).all(axis=0)
    sub = good[:, col_ok].copy()
    holes = np.where(np.isnan(sub))
    sub[holes] = np.take(np.nanmean(sub, axis=0), holes[1])
    corr = np.corrcoef(sub, rowvar=False)
    tick_names = [n for n, ok in zip(names, col_ok) if ok]
    plt.figure(figsize=(8, 6))
    plt.colorbar(plt.imshow(corr, vmin=-1, vmax=1, cmap="coolwarm"), fraction=0.046, pad=0.04)
    plt.xticks(range(len(tick_names)), tick_names, rotation=45, ha="right")
    plt.yticks(range(len(tick_names)), tick_names)
    plt.title("Correlation matrix (Pearson)")
    _save(plt, os.path.join(outdir, f"{prefix}_corr_heatmap.png"))

    pairs = sorted(((abs(corr[i, j]), i, j) for i in range(corr.shape[0])
                    for j in range(i + 1, corr.shape[0])), reverse=True)
    index = np.nonzero(col_ok)[0]
    for rank, (score, i, j) in enumerate(pairs[:max(topk_pairs, 0)]):
        ia, ib = int(index[i]), int(index[j])
        a, b = good[:, ia], good[:, ib]
        both = ~np.isnan(a) & ~np.isnan(b)
        a, b = a[both], b[both]
        if a.size == 0:
            continue
        if a.size > 20_000:
            sel = rng.choice(a.size, 20_000, replace=False)
            a, b = a[sel], b[sel]
        plt.figure(figsize=(5, 5))
        plt.scatter(a, b, s=6, alpha=0.3)
        plt.xlabel(names[ia])
        plt.ylabel(names[ib])
        plt.title(f"Pair scatter: {names[ia]} vs {names[ib]} (|corr|={score:.3f})")
        _save(plt, os.path.join(outdir, f"{prefix}_pair_{rank}_{names[ia]}_vs_{names[ib]}.png"))

    stats = {name: extended_stats(good[:, j]) for j, name in enumerate(names)}
    with open(os.path.join(outdir, f"{prefix}_extended_stats.json"), "w") as f:
        json.dump({"property_names": names, "extended_stats": stats}, f, indent=2)
    return outdir


def _load_target_array(path: str) -> np.ndarray:
    """[n, 12] paper-unit targets of a stats npz (``data``), a QM9 npz
    (``targets_raw`` in ``RAW_KEY_ORDER``, through ``paper_targets``) or the
    first array of any other npz."""
    from ..data.qm9 import RAW_KEY_ORDER, paper_targets

    with np.load(path, allow_pickle=True) as npz:
        if "data" in npz:
            return np.asarray(npz["data"], np.float64)
        if "targets_raw" in npz:
            return np.stack([paper_targets(dict(zip(RAW_KEY_ORDER, row)))
                             for row in np.asarray(npz["targets_raw"], np.float64)])
        return np.asarray(npz[npz.files[0]], np.float64)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="QM9 dataset-statistics plot suite "
                                            "(reference plotstatistics.py CLI)")
    p.add_argument("stats_path", help=".npz with 'data' [n, 12] or a QM9 npz with "
                                      "'targets_raw'")
    p.add_argument("--out_dir", default="stats_plots")
    p.add_argument("--prefix", default="qm9")
    p.add_argument("--topk_pairs", type=int, default=6)
    args = p.parse_args(argv)
    out = plot_qm9_full_stats(_load_target_array(args.stats_path), args.out_dir,
                              prefix=args.prefix, topk_pairs=args.topk_pairs)
    print("All plots saved to:", out)


if __name__ == "__main__":
    main()
