"""QM9 training CLI on one device (port of the JAX package's
train/train_qm9.py; reference train_qm9v3.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_qm9 \\
        --config fixture [--epochs N] [--checkpoint NAME] [--conv-fused] \\
        [--device cuda|cpu]

Trains ``EquiformerV2QM9`` on the 12 paper-order targets (z-scored): L1 loss,
the guarded AdamW on a warmup + cosine schedule, EMA; per epoch the mean
denormalized validation MAE with the EMA weights, the best and periodic
checkpoints (``.pt`` + ``.meta.json``), ``losses.csv`` / ``metrics.json``
and an emergency checkpoint on SIGTERM.  ``--checkpoint`` resumes from a
checkpoint name in the run directory.  The device is the card unless
``--device cpu`` is given.  ``--conv-fused`` sends the SO(2)-conv sites
through kernel K3 (the JAX package's ``ETQ_CONV_FUSED=on``).

Data: the ASE-sqlite database of the config (``fixture``: the committed
``tests/fixtures/train/qm9_train.db``; ``default`` / ``debug``:
``datasets/QM9/qm9.db``), split 80/10/10 as the reference does
(``data/qm9.py:qm9_random_split``).
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch

from ..configs import qm9 as qm9_cfg
from ..data.graph import as_tensors
from ..data.loader import PaddedLoader, infer_pad_sizes
from ..data.qm9 import QM9Dataset, qm9_random_split
from ..models.matpes import init_weights
from ..models.qm9 import EquiformerV2QM9
from ..utils.logging import RunLogger
from ..utils.precision import full_f32_products
from .checkpoint import CheckpointManager, install_sigterm_checkpoint
from .schedules import warmup_cosine
from .trainer import GuardedAdamW, create_train_state, make_qm9_train_step

__all__ = ["main", "build_model", "make_loaders", "predict", "evaluate", "CONFIGS"]

CONFIGS = {"default": qm9_cfg.config, "debug": qm9_cfg.config_debug,
           "conservative": qm9_cfg.config_conservative,
           "aggressive": qm9_cfg.config_aggressive, "fixture": qm9_cfg.config_fixture}


def build_model(cfg: dict, compute_dtype: torch.dtype = torch.float32) -> EquiformerV2QM9:
    """The QM9 model of a config, in the fixed-degree layout unless the
    config's ``fixed_degree`` is False (the JAX CLI's rule), its block
    stack computing in ``compute_dtype``."""
    return EquiformerV2QM9(
        num_targets=len(cfg["target_indices"]) if cfg.get("target_indices") else 12,
        fixed_degree=cfg.get("fixed_degree", True),
        num_layers=cfg["num_layers"], sphere_channels=cfg["sphere_channels"],
        attn_hidden_channels=cfg["attn_hidden_channels"], num_heads=cfg["num_heads"],
        attn_alpha_channels=cfg["attn_alpha_channels"],
        attn_value_channels=cfg["attn_value_channels"],
        ffn_hidden_channels=cfg["ffn_hidden_channels"], lmax=cfg["lmax"],
        mmax=cfg["mmax"], edge_channels=cfg["edge_channels"], num_rbf=cfg["num_rbf"],
        max_num_elements=cfg["max_num_elements"], cutoff=cfg["cutoff"],
        avg_degree=cfg["avg_degree"], alpha_drop=cfg["alpha_drop"],
        drop_path_rate=cfg["drop_path_rate"], proj_drop=cfg.get("proj_drop", 0.0),
        conv_fused=bool(cfg.get("conv_fused", False)), compute_dtype=compute_dtype,
    )


def make_loaders(cfg: dict, splits=("train", "val", "test")):
    """(dataset, {split: PaddedLoader}) of the config's database: the
    reference's random split, pads sized over the dataset as the JAX
    package's CLI sizes them, in the fixed-degree layout unless the
    config's ``fixed_degree`` is False; only ``train`` shuffles."""
    dataset = QM9Dataset(cfg["db_path"], stats_json=cfg.get("stats_json"),
                         max_samples=cfg.get("max_samples"),
                         target_indices=cfg.get("target_indices"))
    idx = dict(zip(("train", "val", "test"),
                   qm9_random_split(len(dataset), cfg["val_split"], cfg["test_split"])))
    fixed_degree = cfg.get("fixed_degree", True)
    n_pad, e_pad = infer_pad_sizes(dataset, cfg["cutoff"], cfg["max_neighbors"],
                                   cfg["batch_size"], fixed_degree=fixed_degree)
    loaders = {s: PaddedLoader(dataset, cfg["batch_size"], cfg["cutoff"],
                               cfg["max_neighbors"], n_pad, e_pad, indices=idx[s],
                               shuffle=s == "train", seed=cfg["seed"],
                               fixed_degree=fixed_degree)
               for s in splits}
    return dataset, loaders


@torch.no_grad()
def predict(model: EquiformerV2QM9, batch: dict, params: dict | None = None) -> torch.Tensor:
    """Normalized predictions [B, T] in ``eval()`` mode, with ``params``
    (e.g. the EMA weights) in place of the model's own when given."""
    model.eval()
    with full_f32_products():
        if params is None:
            return model(batch)
        return torch.func.functional_call(model, params, (batch,))


def evaluate(model, params: dict | None, loader, mean, std, device):
    """Per-target MAE in paper units over ``loader`` (denormalized with
    ``mean`` / ``std``), with the predictions and targets [count, T]."""
    if len(loader) == 0:
        raise ValueError("evaluate: empty loader (fewer samples than batch_size in the "
                         "split: shrink batch_size or raise the split fraction)")
    preds, tgts = [], []
    for pb in loader:
        batch = as_tensors(pb, device)
        preds.append(predict(model, batch, params).cpu().numpy() * std + mean)
        tgts.append(pb.y * std + mean)
    pred, tgt = np.concatenate(preds), np.concatenate(tgts)
    return np.abs(pred - tgt).mean(axis=0), pred, tgt


def main(argv=None, overrides: dict | None = None):
    """Run the CLI; ``overrides`` update the chosen config (for tests).
    Returns the final TrainState."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--conv-fused", action="store_true",
                    help="run the SO(2)-conv sites through kernel K3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = {**CONFIGS[args.config], **(overrides or {})}
    if args.epochs is not None:
        cfg["epochs"] = args.epochs
    if args.conv_fused:
        cfg["conv_fused"] = True
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to train on the CPU)")

    dataset, loaders = make_loaders(cfg, ("train", "val"))
    train_loader, val_loader = loaders["train"], loaders["val"]
    model = build_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg["seed"]))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M  pads: n={train_loader.n_pad} "
          f"e={train_loader.e_pad}  device {device}  conv_fused {cfg['conv_fused']}")

    steps_per_epoch = max(len(train_loader), 1)
    sched = warmup_cosine(cfg["lr"], cfg["warmup_epochs"] * steps_per_epoch,
                          cfg["epochs"] * steps_per_epoch)
    opt = GuardedAdamW(model.named_parameters(), sched, cfg["weight_decay"],
                       cfg["grad_clip"])
    state = create_train_state(model, opt)
    ckpt = CheckpointManager(cfg["run_dir"], cfg)
    if args.checkpoint:
        meta = ckpt.restore(args.checkpoint, state)
        print(f"resumed from {args.checkpoint}: epoch {meta.get('epoch')}, step {state.step}")
    logger = RunLogger(cfg["run_dir"], cfg)
    gen = torch.Generator(device=device).manual_seed(cfg["seed"])
    step_fn = make_qm9_train_step(state, cfg["loss"], cfg["ema_decay"], gen)
    previous = install_sigterm_checkpoint(lambda: state, ckpt)
    try:
        best_val = np.inf
        for epoch in range(cfg["epochs"]):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            losses, skipped = [], 0
            for pb in train_loader:
                loss, metrics = step_fn(as_tensors(pb, device))
                if metrics["accepted"]:
                    losses.append(float(loss))
                else:
                    skipped += 1  # the guard skipped this update
            val_mae, _, _ = evaluate(model, state.ema, val_loader, dataset.mean,
                                     dataset.std, device)
            mean_val = float(np.mean(val_mae))
            dt = time.time() - t0
            train_loss = float(np.mean(losses)) if losses else float("nan")
            print(f"epoch {epoch}: loss={train_loss:.4f} val_mae={mean_val:.4f} "
                  f"skipped={skipped} ({dt:.1f}s)")
            logger.log_epoch(epoch, {"train_loss": train_loss, "val_mae": mean_val,
                                     "skipped": skipped, "sec": dt})
            if mean_val < best_val:
                best_val = mean_val
                ckpt.save_best(state, {"epoch": epoch, "val_mae": mean_val})
            if (epoch + 1) % cfg["ckpt_every_epochs"] == 0:
                ckpt.save_periodic(epoch, state, {"val_mae": mean_val})
        logger.update_metrics(best_val_mae=best_val, num_params=n_params, steps=state.step)
        logger.finalize()
    finally:
        signal.signal(signal.SIGTERM, previous)
    return state


if __name__ == "__main__":
    main()
