"""QM9 checkpoint evaluation CLI (port of the JAX package's train/test_qm9.py;
reference test_qm9v3.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.test_qm9 \\
        --checkpoint runs/qm9_fixture_torch/ckpt_best [--run-dir DIR] \\
        [--split test|val] [--use-ema] [--device cuda|cpu]

Loads a checkpoint of the port (``<name>.pt`` + ``<name>.meta.json``, as
train/train_qm9.py writes them), rebuilds the model from the stored config,
and writes ``eval_<split>.json`` (per-property MAE in paper units),
``predictions.npy`` and ``targets.npy`` into the run directory
(``--run-dir``, where the checkpoint is read; default: the checkpoint's
directory), with the
EMA weights (as the JAX package's CLI does: its ``--use-ema`` is a
``store_true`` flag whose default is already True, so it is accepted here
and the EMA weights are always used).  ``evaluate_state_dict`` does
the same for any ``state_dict`` (for example one converted from the JAX
package's Flax params by utils/convert.py).  The device is the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.qm9 import PROPERTY_ORDER
from .train_qm9 import build_model, evaluate, make_loaders

__all__ = ["main", "evaluate_state_dict"]


def evaluate_state_dict(cfg: dict, state_dict: dict, split: str = "test",
                        device="cuda", out_dir: str | None = None) -> dict:
    """Per-property MAE of ``state_dict`` on the config's ``split``; with
    ``out_dir``, the record and the arrays are written there."""
    dataset, loaders = make_loaders(cfg, (split,))
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    model.to(device)
    mae, pred, tgt = evaluate(model, None, loaders[split], dataset.mean, dataset.std, device)
    names = ([PROPERTY_ORDER[i] for i in cfg["target_indices"]]
             if cfg.get("target_indices") else PROPERTY_ORDER)
    out = {"split": split, "count": int(pred.shape[0]),
           "mae": {nm: float(m) for nm, m in zip(names, mae)}}
    if out_dir is not None:
        np.save(os.path.join(out_dir, "predictions.npy"), pred)
        np.save(os.path.join(out_dir, "targets.npy"), tgt)
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
    ap.add_argument("--use-ema", action="store_true", default=True,
                    help="evaluate the EMA weights (always on, as in the JAX CLI)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_dir = args.run_dir or os.path.dirname(args.checkpoint) or "."
    path = os.path.join(run_dir, os.path.basename(args.checkpoint))
    with open(f"{path}.meta.json") as f:
        cfg = json.load(f)["config"]
    sd = torch.load(f"{path}.pt", map_location="cpu", weights_only=True)
    out = evaluate_state_dict(cfg, {**sd["model"], **sd["ema"]}, args.split, args.device,
                              run_dir)
    print(f"\nQM9 {args.split} MAE (paper units), {out['count']} molecules:")
    for nm, m in out["mae"].items():
        print(f"  {nm:8s}: {m:.4f}")
    return out


if __name__ == "__main__":
    main()
