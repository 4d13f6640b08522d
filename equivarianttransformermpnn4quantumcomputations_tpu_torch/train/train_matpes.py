"""MatPES training CLI on one device (port of the JAX package's
train/train_matpes.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_matpes \\
        --config synthetic [--epochs N] [--mixed-precision] [--checkpoint NAME] \\
        [--device cuda|cpu]

Trains the MatPES GATA-V2 model with forces by autograd (the loss backward
is a grad-of-grad), the guarded AdamW, EMA, per-epoch evaluation with the
EMA weights (energy / force MAE in meV), the best and periodic checkpoints,
``losses.csv`` / ``metrics.json`` and an emergency checkpoint on SIGTERM.
``--checkpoint`` resumes from a checkpoint name in the run directory.
The device is the card unless ``--device cpu`` is given.

Data: ``--config synthetic`` trains on ``data/synthetic.py``'s LJ crystals.
Loading the MatPES dataset (the JAX package's data/matpes.py) is not ported
yet, so ``default`` and ``debug`` stop with a message; multi-host and
sharded-mesh training are not ported either.
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch

from ..configs import matpes as mp_cfg
from ..data.graph import as_tensors
from ..data.loader import PaddedLoader, infer_pad_sizes
from ..data.synthetic import SyntheticCrystals
from ..models.matpes import EquiformerV2MatPES, init_weights, matpes_energy_forces
from ..utils.logging import RunLogger
from ..utils.precision import full_f32_products
from .checkpoint import CheckpointManager, install_sigterm_checkpoint
from .schedules import warmup_cosine
from .trainer import GuardedAdamW, create_train_state, make_matpes_train_step

__all__ = ["main", "evaluate", "build_model"]

CONFIGS = {"default": mp_cfg.config, "debug": mp_cfg.config_debug,
           "synthetic": mp_cfg.synthetic}


# model keys of the config whose other values the port cannot build yet
_NOT_PORTED = {"normalize_attn_output": (False, "the attention without its output "
                                         "normalization"),
               "use_phi_every_layer": (True, "the distance RBF in every layer's value path"),
               "regress_stress": (True, "stress regression")}


def build_model(cfg: dict, mixed_precision: bool) -> EquiformerV2MatPES:
    """The model of every model key of ``cfg`` (a missing key raises
    ``KeyError``); a value the port cannot build yet raises ``ValueError``
    naming its key, rather than training another model."""
    for key, (value, what) in _NOT_PORTED.items():
        if cfg[key] == value:
            raise ValueError(f"{key}={value!r} ({what}) is not ported yet (ROADMAP.md)")
    if cfg["w_stress"] > 0.0:
        raise ValueError(f"w_stress={cfg['w_stress']} (stress regression) is not ported yet "
                         "(ROADMAP.md)")
    return EquiformerV2MatPES(
        num_layers=cfg["num_layers"], sphere_channels=cfg["sphere_channels"],
        attn_hidden_channels=cfg["attn_hidden_channels"], num_heads=cfg["num_heads"],
        attn_alpha_channels=cfg["attn_alpha_channels"],
        attn_value_channels=cfg["attn_value_channels"],
        ffn_hidden_channels=cfg["ffn_hidden_channels"], lmax=cfg["lmax"],
        mmax=cfg["mmax"], grid_resolution=cfg["grid_resolution"],
        edge_channels=cfg["edge_channels"], num_rbf=cfg["num_rbf"],
        max_num_elements=cfg["max_num_elements"], cutoff=cfg["cutoff"],
        avg_degree=cfg["avg_degree"], alpha_drop=cfg["alpha_drop"],
        drop_path_rate=cfg["drop_path_rate"],
        compute_dtype=torch.bfloat16 if mixed_precision else torch.float32,
        conv_fused=bool(cfg["conv_fused"]), gata=bool(cfg["gata"]),
        wigner_rep=cfg["wigner_rep"],
    )


@torch.no_grad()
def evaluate(model, params: dict, loader, energy_std: float, device) -> tuple[float, float]:
    """Energy MAE (meV/atom) and force MAE (meV/A) with ``params`` (the EMA
    weights), denormalized (reference test_MatPES.py:89-152)."""
    model.eval()
    e_err = f_err = 0.0
    e_cnt = f_cnt = 0
    for pb in loader:
        batch = as_tensors(pb, device)
        with full_f32_products():
            outs = matpes_energy_forces(model, batch, params=params)
        e_err += (outs["energy"][:, 0] - batch["energy"]).abs().sum().item()
        e_cnt += batch["energy"].shape[0]
        m = batch["node_mask"]
        f_err += (outs["forces"][m] - batch["forces"][m]).abs().sum().item()
        f_cnt += 3 * int(m.sum())
    return (e_err / max(e_cnt, 1) * energy_std * 1000.0,
            f_err / max(f_cnt, 1) * energy_std * 1000.0)


def main(argv=None, overrides: dict | None = None):
    """Run the CLI; ``overrides`` update the chosen config (for tests).
    Returns the final TrainState."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--mixed-precision", action="store_true",
                    help="bf16 compute, f32 master params and norms")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = {**CONFIGS[args.config], **(overrides or {})}
    if args.epochs is not None:
        cfg["epochs"] = args.epochs
    if not cfg.get("synthetic"):
        raise SystemExit("loading the MatPES dataset is not ported yet; "
                         "use --config synthetic")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to train on the CPU)")
    mixed_precision = bool(args.mixed_precision or cfg.get("mixed_precision", False))

    train_ds = SyntheticCrystals(n_samples=cfg.get("max_train") or 64)
    # val shares the train normalization
    val_ds = SyntheticCrystals(n_samples=cfg.get("max_val") or 16, seed=1,
                               stats=train_ds.stats)
    stats = {"energy_mean": 0.0, "energy_std": 1.0}
    n_pad, e_pad = infer_pad_sizes(train_ds, cfg["max_neighbors"], cfg["batch_size"])

    def loader(ds, shuffle):
        return PaddedLoader(ds, cfg["batch_size"], cfg["cutoff"], cfg["max_neighbors"],
                            n_pad, e_pad, shuffle=shuffle, seed=cfg["seed"])

    train_loader, val_loader = loader(train_ds, True), loader(val_ds, False)

    model = build_model(cfg, mixed_precision)
    init_weights(model, torch.Generator().manual_seed(cfg["seed"]))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model params: {n_params / 1e6:.2f}M  pads: n={n_pad} e={e_pad}  "
          f"device {device}  {'bf16' if mixed_precision else 'f32'} compute")

    steps_per_epoch = max(len(train_loader), 1)
    sched = warmup_cosine(cfg["lr"], cfg["warmup_epochs"] * steps_per_epoch,
                          cfg["epochs"] * steps_per_epoch)
    opt = GuardedAdamW(model.named_parameters(), sched, cfg["weight_decay"],
                       cfg["grad_clip"])
    state = create_train_state(model, opt)
    ckpt = CheckpointManager(cfg["run_dir"], {**cfg, **stats})
    if args.checkpoint:
        meta = ckpt.restore(args.checkpoint, state)
        print(f"resumed from {args.checkpoint}: epoch {meta.get('epoch')}, "
              f"step {state.step}")
    logger = RunLogger(cfg["run_dir"], cfg)
    gen = torch.Generator(device=device).manual_seed(cfg["seed"])
    step_fn = make_matpes_train_step(state, cfg["w_energy"], cfg["w_force"], 0.0,
                                     cfg["ema_decay"], gen)
    previous = install_sigterm_checkpoint(lambda: state, ckpt)
    try:
        _train(cfg, state, step_fn, train_loader, val_loader, stats, ckpt, logger,
               n_params, device)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return state


def _train(cfg, state, step_fn, train_loader, val_loader, stats, ckpt, logger,
           n_params, device) -> None:
    """The epoch loop: train, evaluate with the EMA weights, checkpoint, log."""
    best_val = np.inf
    nan_batches = 0
    for epoch in range(cfg["epochs"]):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        losses = []
        for pb in train_loader:
            loss, metrics = step_fn(as_tensors(pb, device))
            loss = float(loss)
            if not metrics["accepted"] or not np.isfinite(loss):
                nan_batches += 1  # the guard skipped this update
            else:
                losses.append(loss)
        e_mae, f_mae = evaluate(state.model, state.ema, val_loader, stats["energy_std"],
                                device)
        dt = time.time() - t0
        print(f"epoch {epoch}: loss={np.mean(losses) if losses else float('nan'):.4f} "
              f"E={e_mae:.1f} meV/atom F={f_mae:.1f} meV/A "
              f"nan_skipped={nan_batches} ({dt:.1f}s)")
        if train_loader.overflow_batches:
            print(f"  WARNING: {train_loader.overflow_batches} batches overflowed the "
                  f"static pads this epoch (dropped {train_loader.overflow_atoms} atoms / "
                  f"{train_loader.overflow_edges} edges); raise n_pad/e_pad")
        logger.log_epoch(epoch, {
            "train_loss": float(np.mean(losses)) if losses else float("nan"),
            "val_energy_mae_mev": e_mae, "val_force_mae_mev": f_mae,
            "nan_batches": nan_batches,
            "overflow_batches": train_loader.overflow_batches,
            "overflow_atoms": train_loader.overflow_atoms,
            "overflow_edges": train_loader.overflow_edges, "sec": dt,
        })
        score = e_mae + f_mae
        if score < best_val:
            best_val = score
            ckpt.save_best(state, {"epoch": epoch, "val_score": score})
        if (epoch + 1) % cfg["ckpt_every_epochs"] == 0:
            ckpt.save_periodic(epoch, state, {"val_score": score})

    logger.update_metrics(best_val_score=best_val, num_params=n_params, steps=state.step)
    logger.finalize()


if __name__ == "__main__":
    main()
