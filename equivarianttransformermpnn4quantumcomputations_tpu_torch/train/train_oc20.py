"""OC20 S2EF training CLI (port of the JAX package's train/train_oc20.py;
reference train_oc20v2.py and train_oc20v2_parallel.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_oc20 \\
        --config synthetic [--epochs N] [--checkpoint NAME] [--run-dir DIR] \\
        [--device cuda|cpu] [--multihost] [--data-parallel]

Trains ``EquiformerV2OC20`` (energy head + explicit force head) with the
loss E-MSE x w_energy + F-L1 x w_force, the guarded AdamW on a per-step
warmup + cosine schedule and EMA; per epoch the denormalized validation
MAEs (energy meV, force meV/A, OCP units) with the EMA weights, the best
and periodic checkpoints (``.pt`` + ``.meta.json``), ``losses.csv`` /
``metrics.json`` and an emergency checkpoint on SIGTERM.  ``--checkpoint``
resumes from a checkpoint name in the run directory.  The device is the
card unless ``--device cpu`` is given.

Data: ``--config synthetic`` trains on ``data/synthetic.py``'s periodic LJ
crystals and needs no dataset; ``default`` and ``debug`` read the extxyz
directories of the config (``datasets/OC20/...``, not in the repository).

Data-parallel training (the reference's DDP trainer):
``--multihost --data-parallel`` in each of D processes (one per GPU, as
``torchrun`` starts them; ``parallel/multihost.py`` reads RANK / WORLD_SIZE
/ MASTER_ADDR) averages the gradients of D micro-batches a step
(``parallel/data_parallel.py``), one from each rank's shard of the training
data; rank 0 alone writes logs and checkpoints.  The JAX CLI runs one
process over D devices and gives them D consecutive batches of one loader;
here rank r's micro-batch is the next batch of its shard (every D-th
structure of the shuffled order), so other structures share a step.  With
one process ``--data-parallel`` takes the plain step, as the JAX CLI does on
one device.
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import oc20 as oc_cfg
from ..data.graph import as_tensors
from ..data.loader import PaddedLoader, infer_pad_sizes
from ..data.oc20 import OC20_ENERGY_STD, OC20Dataset
from ..data.synthetic import SyntheticCrystals
from ..models.matpes import init_weights
from ..models.oc20 import EquiformerV2OC20
from ..parallel import multihost
from ..parallel.data_parallel import make_oc20_dp_step, microbatches, rank_seed
from ..utils.logging import RunLogger
from ..utils.precision import full_f32_products
from .checkpoint import CheckpointManager, install_sigterm_checkpoint
from .schedules import warmup_cosine
from .trainer import GuardedAdamW, cast_params, create_train_state, make_oc20_train_step

__all__ = ["main", "build_oc20_model", "make_datasets", "make_loader", "predict",
           "evaluate", "CONFIGS"]

CONFIGS = {"default": oc_cfg.config, "debug": oc_cfg.config_debug,
           "synthetic": oc_cfg.config_synthetic}


def build_oc20_model(cfg: dict, compute_dtype: torch.dtype = torch.float32) -> EquiformerV2OC20:
    """``EquiformerV2OC20`` from a config (shared by the trainer and
    train/test_oc20.py, which rebuilds it from a checkpoint's config), in
    the fixed-degree layout unless the config's ``fixed_degree`` is False."""
    return EquiformerV2OC20(
        fixed_degree=cfg.get("fixed_degree", True),
        num_layers=cfg["num_layers"], sphere_channels=cfg["sphere_channels"],
        attn_hidden_channels=cfg["attn_hidden_channels"], num_heads=cfg["num_heads"],
        attn_alpha_channels=cfg["attn_alpha_channels"],
        attn_value_channels=cfg["attn_value_channels"],
        ffn_hidden_channels=cfg["ffn_hidden_channels"], lmax=cfg["lmax"], mmax=cfg["mmax"],
        edge_channels=cfg["edge_channels"], num_rbf=cfg["num_rbf"],
        max_num_elements=cfg["max_num_elements"], cutoff=cfg["cutoff"],
        alpha_drop=cfg["alpha_drop"], drop_path_rate=cfg["drop_path_rate"],
        avg_num_nodes=cfg["avg_num_nodes"], avg_degree=cfg["avg_degree"],
        compute_dtype=compute_dtype, conv_fused=bool(cfg["conv_fused"]),
        wigner_rep=cfg["wigner_rep"],
    )


def make_datasets(cfg: dict, data_path: str | None = None):
    """(train, val) datasets of the config: synthetic crystals, or the
    extxyz directories ``data_path`` / ``val_path``."""
    if cfg.get("synthetic") and data_path is None:
        ds = SyntheticCrystals(n_samples=cfg["n_samples"], n_atoms=cfg["n_atoms"])
        return ds, ds
    train = OC20Dataset(data_path or cfg["data_path"])
    val = OC20Dataset(cfg["val_path"]) if cfg.get("val_path") and data_path is None else train
    return train, val


def make_loader(cfg: dict, dataset, n_pad: int, e_pad: int, shuffle: bool,
                shards: tuple[int, int] = (1, 0)) -> PaddedLoader:
    """The config's loader; ``shards`` = (number of shards, this shard)."""
    return PaddedLoader(dataset, cfg["batch_size"], cfg["cutoff"], cfg["max_neighbors"],
                        n_pad, e_pad, shuffle=shuffle, seed=cfg["seed"],
                        fixed_degree=cfg.get("fixed_degree", True), num_shards=shards[0],
                        shard_id=shards[1])


@torch.no_grad()
def predict(model: EquiformerV2OC20, batch: dict, params: dict | None = None) -> dict:
    """Energies [B] and forces [N, 3] (normalized) in ``eval()`` mode, with
    ``params`` (e.g. the EMA weights) in place of the model's own; a model
    that computes in bfloat16 runs on bfloat16 copies, as in training."""
    model.eval()
    cdt = model.backbone.compute_dtype
    with full_f32_products():
        if cdt != torch.float32:
            params = cast_params(model, cdt, params)
        if params is None:
            return model(batch)
        return torch.func.functional_call(model, params, (batch,))


def evaluate(model, params: dict | None, loader, device) -> tuple[float, float]:
    """Denormalized MAEs over ``loader``: energy (eV) and force (eV/A) in
    OCP units, |error| x the OCP std; the force MAE over real atoms."""
    e_err = f_err = 0.0
    e_cnt = f_cnt = 0
    for pb in loader:
        batch = as_tensors(pb, device)
        outs = predict(model, batch, params)
        e_err += (outs["energy"].float() - batch["energy"]).abs().sum().item()
        e_cnt += batch["energy"].shape[0]
        m = batch["node_mask"]
        f_err += (outs["forces"].float()[m] - batch["forces"][m]).abs().sum().item()
        f_cnt += 3 * int(m.sum())
    return (e_err / max(e_cnt, 1) * OC20_ENERGY_STD, f_err / max(f_cnt, 1) * OC20_ENERGY_STD)


def main(argv=None, overrides: dict | None = None):
    """Run the CLI; ``overrides`` update the chosen config (for tests).
    Returns the final TrainState."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="default", choices=sorted(CONFIGS))
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-parallel", action="store_true",
                    help="average the gradients of one micro-batch per process a step")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group of RANK / WORLD_SIZE / MASTER_ADDR env vars "
                         "(no-op single-process); per-rank data shards, rank-0-only writes: "
                         "the reference DDP contract (train_oc20v2_parallel.py:34-54)")
    args = ap.parse_args(argv)
    cfg = {**CONFIGS[args.config], **(overrides or {})}
    if args.epochs is not None:
        cfg["epochs"] = args.epochs
    if args.run_dir is not None:
        cfg["run_dir"] = args.run_dir
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to train on the CPU)")
    owns_group = args.multihost and not dist.is_initialized()
    if args.multihost and multihost.initialize_from_env(device=args.device) \
            and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world, rank, primary = (multihost.process_count(), multihost.process_index(),
                            multihost.is_primary())
    if world > 1 and not args.data_parallel:
        raise SystemExit(f"{world} processes train together only with --data-parallel")

    train_ds, val_ds = make_datasets(cfg)
    n_pad, e_pad = infer_pad_sizes(train_ds, cfg["cutoff"], cfg["max_neighbors"],
                                   cfg["batch_size"], fixed_degree=cfg.get("fixed_degree", True))
    train_loader = make_loader(cfg, train_ds, n_pad, e_pad, True, (world, rank))
    val_loader = make_loader(cfg, val_ds, n_pad, e_pad, False)

    model = build_oc20_model(cfg)
    init_weights(model, torch.Generator().manual_seed(cfg["seed"]))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    if primary:
        print(f"model params: {n_params / 1e6:.2f}M  pads: n={n_pad} e={e_pad}  device "
              f"{device}  wigner {cfg['wigner_rep']}"
              + (f"  data-parallel over {world} processes" if world > 1 else ""))

    steps_per_epoch = max(len(train_loader), 1)
    sched = warmup_cosine(cfg["lr"], cfg["warmup_steps"], cfg["epochs"] * steps_per_epoch)
    opt = GuardedAdamW(model.named_parameters(), sched, cfg["weight_decay"], cfg["grad_clip"])
    state = create_train_state(model, opt)
    ckpt = CheckpointManager(cfg["run_dir"], cfg, primary=primary)
    if args.checkpoint:
        meta = ckpt.restore(args.checkpoint, state)
        if primary:
            print(f"resumed from {args.checkpoint}: epoch {meta.get('epoch')}, "
                  f"step {state.step}")
    logger = RunLogger(cfg["run_dir"], cfg, primary=primary)
    gen = torch.Generator(device=device).manual_seed(rank_seed(cfg["seed"], rank))
    if world == 1:
        step_fn = make_oc20_train_step(state, cfg["w_energy"], cfg["w_force"],
                                       cfg["ema_decay"], gen)

        def batches(loader):
            return (as_tensors(pb, device) for pb in loader)
    else:
        step_fn = make_oc20_dp_step(state, world, cfg["w_energy"], cfg["w_force"],
                                    cfg["ema_decay"], gen)
        n_steps = len(train_loader.indices) // world // cfg["batch_size"]

        def batches(loader):
            return microbatches(loader, device, 1, n_steps)
    previous = install_sigterm_checkpoint(lambda: state, ckpt) if primary else None
    try:
        best = np.inf
        for epoch in range(cfg["epochs"]):
            train_loader.set_epoch(epoch)
            t0 = time.time()
            losses, skipped = [], 0
            for batch in batches(train_loader):
                loss, metrics = step_fn(batch)
                if metrics["accepted"]:
                    losses.append(float(loss))
                else:
                    skipped += 1  # the guard skipped this update
            e_mae, f_mae = evaluate(model, state.ema, val_loader, device)
            dt = time.time() - t0
            train_loss = float(np.mean(losses)) if losses else float("nan")
            if primary:
                print(f"epoch {epoch}: loss={train_loss:.4f} E={e_mae * 1000:.1f} meV "
                      f"F={f_mae * 1000:.1f} meV/A skipped={skipped} ({dt:.1f}s)")
            logger.log_epoch(epoch, {"train_loss": train_loss, "val_e_mae": e_mae,
                                     "val_f_mae": f_mae, "skipped": skipped, "sec": dt})
            score = e_mae + f_mae
            if score < best:
                best = score
                ckpt.save_best(state, {"epoch": epoch, "score": score})
            if (epoch + 1) % cfg["ckpt_every_epochs"] == 0:
                ckpt.save_periodic(epoch, state, {"score": score})
        logger.update_metrics(best_score=best, num_params=n_params, steps=state.step)
        logger.finalize()
    finally:
        if primary:
            signal.signal(signal.SIGTERM, previous)
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
