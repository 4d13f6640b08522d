"""OC20 checkpoint evaluation CLI (port of the JAX package's
train/test_oc20.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.test_oc20 \\
        --checkpoint runs/oc20_torch_synthetic/ckpt_best [--run-dir DIR] \\
        [--data-path DIR] [--split val|test] [--device cuda|cpu]

Loads a checkpoint of the port (``<name>.pt`` + ``<name>.meta.json``, as
train/train_oc20.py writes them), rebuilds the model from the stored config
and reports the S2EF energy and force MAE in OCP units (|error| x the OCP
std) with the EMA weights, as the JAX package's CLI does.  The data are the
config's validation data (synthetic crystals for ``synthetic``, else its
``val_path``) unless ``--data-path`` names an extxyz directory.  As in the
JAX CLI, ``--split`` (default ``val``) selects no data: it names the
output, ``eval_oc20_<split>.json``, which goes, with the data it was
measured on, to ``--run-dir`` (default: the checkpoint's directory), where
the checkpoint is read too.  The device is the card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.loader import infer_pad_sizes
from .train_oc20 import build_oc20_model, evaluate, make_datasets, make_loader

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True,
                    help="<run_dir>/<name> of a port checkpoint (without .pt)")
    ap.add_argument("--run-dir", default=None,
                    help="the checkpoint's directory (default: that of --checkpoint)")
    ap.add_argument("--data-path", default=None, help="an extxyz directory to evaluate on")
    ap.add_argument("--split", default="val", choices=["val", "test"],
                    help="the name of the output, eval_oc20_<split>.json (selects no data)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to evaluate on the CPU)")
    run_dir = args.run_dir or os.path.dirname(args.checkpoint) or "."
    path = os.path.join(run_dir, os.path.basename(args.checkpoint))
    with open(f"{path}.meta.json") as f:
        meta = json.load(f)
    cfg = meta["config"]
    _, ds = make_datasets(cfg, args.data_path)
    data = args.data_path or ("synthetic" if cfg.get("synthetic")
                              else cfg.get("val_path") or cfg["data_path"])
    n_pad, e_pad = infer_pad_sizes(ds, cfg["cutoff"], cfg["max_neighbors"], cfg["batch_size"],
                                   fixed_degree=cfg.get("fixed_degree", True))
    loader = make_loader(cfg, ds, n_pad, e_pad, False)
    sd = torch.load(f"{path}.pt", map_location="cpu", weights_only=True)
    model = build_oc20_model(cfg)
    model.load_state_dict({**sd["model"], **sd["ema"]})
    model.to(device)
    print(f"checkpoint: epoch {meta.get('epoch')}, score {meta.get('score')}")
    e_mae, f_mae = evaluate(model, None, loader, device)
    print(f"\nOC20 S2EF {args.split} on {data} ({len(ds)} frames):")
    print(f"  energy MAE: {e_mae * 1000:.1f} meV")
    print(f"  force  MAE: {f_mae * 1000:.1f} meV/A")
    out = {"split": args.split, "data": data, "n_frames": len(ds),
           "energy_mae_mev": e_mae * 1000, "force_mae_mev_per_a": f_mae * 1000}
    with open(os.path.join(run_dir, f"eval_oc20_{args.split}.json"), "w") as f:
        json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
