"""MatPES checkpoint evaluation CLI (port of the JAX package's
train/test_matpes.py; reference test_MatPES.py / test_MatPES_GATA.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.test_matpes \\
        --checkpoint runs/matpes_fixture_torch/ckpt_best [--run-dir DIR] \\
        [--split test|val] [--device cuda|cpu]

Loads a checkpoint of the port (``<name>.pt`` + ``<name>.meta.json``, as
train/train_matpes.py writes them), rebuilds the model from the stored
config (float32, dropout off), evaluates the EMA weights on the config's
data (energy MAE in meV/atom, force MAE in meV/A, forces by autograd),
checks the stored ``energy_std`` against the recomputed one (the stored one
wins), prints the reference's literature table and writes
``eval_<split>.json`` beside the checkpoint, naming the data it read.
``evaluate_state_dict`` does the same for any ``state_dict`` (for example
one converted from the JAX package's Flax params by utils/convert.py).
The device is the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.loader import PaddedLoader, infer_pad_sizes
from .train_matpes import build_eval_model, evaluate, load_data

__all__ = ["main", "evaluate_state_dict", "LITERATURE"]

# literature anchors printed by the reference (test_MatPES.py:158-160):
# (model, energy MAE eV/atom, f / f_DFT)
LITERATURE = [("M3GNet", 0.11, 0.97), ("CHGNet", 0.082, 0.91), ("TensorNet", 0.081, 0.93)]


def evaluate_state_dict(cfg: dict, state_dict: dict, split: str = "test", device="cuda",
                        out_dir: str | None = None) -> dict:
    """Energy and force MAE of ``state_dict`` on the config's ``split``;
    with ``out_dir``, ``eval_<split>.json`` is written there."""
    train_ds, val_ds, test_ds, stats = load_data(cfg)
    if "energy_std" in cfg and abs(stats["energy_std"] - cfg["energy_std"]) > 1e-6:
        print(f"WARNING: recomputed energy_std {stats['energy_std']:.6f} != checkpoint "
              f"{cfg['energy_std']:.6f}; using the checkpoint's")
        stats["energy_std"] = cfg["energy_std"]
    ds = test_ds if split == "test" else val_ds
    # the JAX CLI's layout: fixed-degree unless the config says otherwise
    fixed_degree = cfg.get("fixed_degree", True)
    n_pad, e_pad = infer_pad_sizes(ds, cfg["cutoff"], cfg["max_neighbors"], cfg["batch_size"],
                                   fixed_degree=fixed_degree)
    loader = PaddedLoader(ds, cfg["batch_size"], cfg["cutoff"], cfg["max_neighbors"],
                          n_pad, e_pad, fixed_degree=fixed_degree)
    model = build_eval_model({**cfg, "uniform_blocks": False, "fixed_degree": fixed_degree})
    model.load_state_dict(state_dict)
    model.to(device)
    e_mae, f_mae = evaluate(model, None, loader, stats["energy_std"], device)
    out = {"energy_mae_mev_per_atom": float(e_mae), "force_mae_mev_per_a": float(f_mae),
           "split": split, "count": len(loader) * cfg["batch_size"],
           "data": "synthetic" if cfg.get("synthetic") else cfg["data_path"],
           "split_path": None if cfg.get("synthetic") else cfg.get("split_path"),
           "device": str(device)}
    if out_dir is not None:
        with open(os.path.join(out_dir, f"eval_{split}.json"), "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="<run_dir>/<name> of a port checkpoint (without .pt)")
    ap.add_argument("--run-dir", default=None,
                    help="the checkpoint's directory (default: that of --checkpoint)")
    ap.add_argument("--split", default="test", choices=["val", "test"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to evaluate on the CPU)")
    run_dir = args.run_dir or os.path.dirname(args.checkpoint) or "."
    path = os.path.join(run_dir, os.path.basename(args.checkpoint))
    with open(f"{path}.meta.json") as f:
        cfg = json.load(f)["config"]
    sd = torch.load(f"{path}.pt", map_location="cpu", weights_only=True)
    out = evaluate_state_dict(cfg, {**sd["model"], **sd["ema"]}, args.split, device, run_dir)
    e_mae = out["energy_mae_mev_per_atom"]
    print(f"\nMatPES {args.split} ({out['count']} structures of {out['data']}, EMA weights, "
          f"{device}):")
    print(f"  energy MAE: {e_mae:.2f} meV/atom")
    print(f"  force  MAE: {out['force_mae_mev_per_a']:.2f} meV/A")
    print("\nComparison (MatCalc-Benchmark energy MAE, eV/atom):")
    for name, e, fr in LITERATURE:
        print(f"  {name:10s}: {e:.3f} (f/f_DFT {fr:.2f})")
    print(f"  {'this work':10s}: {e_mae / 1000:.4f}")
    return out


if __name__ == "__main__":
    main()
