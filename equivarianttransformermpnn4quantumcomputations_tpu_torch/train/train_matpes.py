"""MatPES training CLI (port of the JAX package's train/train_matpes.py).

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.train.train_matpes \\
        --config fixture [--epochs N] [--mixed-precision] [--checkpoint NAME] \\
        [--device cuda|cpu] [--multihost] [--mesh data=D[,model=M|pipe=P][,sp]]

Configs (the JAX CLI's names): ``default`` (GATA-V2), ``debug``,
``no-attn-norm``, ``phi-every-layer``, ``baseline`` (the original
EquiformerV2 with stress), ``synthetic``, ``synthetic-convergence`` and
``fixture``.  Trains the MatPES model with forces by autograd (the loss
backward is a grad-of-grad; with ``regress_stress`` also the per-graph
stress, weighted by ``w_stress``), the guarded AdamW, EMA, evaluation with
the EMA weights every ``eval_every`` epochs (energy / force MAE in meV),
the best and periodic checkpoints, ``losses.csv`` / ``metrics.json`` and an
emergency checkpoint on SIGTERM.  ``--checkpoint`` resumes from a
checkpoint name in the run directory.  The device is the card unless
``--device cpu`` is given.

Data: ``synthetic`` and ``synthetic-convergence`` train on
``data/synthetic.py``'s LJ crystals; every other config reads its MatPES
json(.gz) and split file (``data/matpes.py``) and stops, naming the path,
when the file is missing.

Data-parallel training: ``--mesh data=N`` averages the gradients of N
micro-batches a step (``parallel/data_parallel.py``), split over the
processes of a ``--multihost`` run (one per GPU, as ``torchrun`` starts
them: ``parallel/multihost.py`` reads RANK / WORLD_SIZE / MASTER_ADDR);
each rank reads its shard of the training data, and rank 0 alone writes
logs and checkpoints.  Without ``--multihost``, or with one process, the
one process runs all N micro-batches.

Composite training, as the JAX CLI: ``--mesh data=D,model=M[,sp]`` with
M > 1 runs ``parallel/sharding.py``'s DP x TP x EP (x SP) step over the
world's processes laid out as (world / M) data rows of M model ranks: M
must divide the world and D be a multiple of world / M (each data row runs
D M / world micro-batches a step and reads its shard of the data; the ranks
of a row read the same).  ``model=2`` alone is data=1, model=2.  Each rank
holds its share of the sharded weights, AdamW moments and EMA; rank 0
gathers the state and writes the same checkpoint files as a one-process
run, and ``--checkpoint`` re-shards one.  ``sp`` splits the edge axis over
``model`` too; at model=1 it does nothing (``data=2,sp`` trains
data-parallel).  The composite step, like the JAX one, keeps the float32
parameters in the forward of a ``--mixed-precision`` model.

Pipeline training, as the JAX CLI: ``--mesh data=D,pipe=P`` runs
``parallel/pipeline.py``'s DP x GPipe step over the world's processes laid
out as (world / P) data rows of P stages (P must divide the world and D be
a multiple of world / P; each row runs D P / world micro-batches a step
through its P-stage pipeline and reads its shard of the data).  Each stage
holds its num_layers / P blocks (their masters, AdamW moments and EMA) and
every other leaf whole; rank 0 gathers the state and writes the checkpoint
files of a one-process run, ``--checkpoint`` re-shards one, and evaluation
runs through the pipeline.  As in the JAX CLI it needs ``scan_layers`` in
the config (the layer stack's layout; ``default`` has it off), takes no
stress, cannot be combined with ``model=``, and ignores ``sp``; with
``--mixed-precision`` the stages compute on bfloat16 copies of the masters,
as the JAX pipeline step does.  A sharded run (composite or pipeline)
writes no emergency checkpoint on SIGTERM (that would need every rank).

Memory, as the JAX CLI: the config's ``remat`` builds the model with each
block rematerialized in every backward, and ``inner_ckpt`` rematerializes
the whole energy evaluation in the loss's backward (nn/remat.py); both
cut the force step's peak device memory for a longer step.  Every step
takes ``remat``; the pipelined step refuses ``inner_ckpt``.
"""

from __future__ import annotations

import argparse
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import matpes as mp_cfg
from ..data.graph import as_tensors
from ..data.loader import PaddedLoader, infer_pad_sizes
from ..data.matpes import load_matpes
from ..data.synthetic import SyntheticCrystals
from ..models.matpes import EquiformerV2MatPES, init_weights, matpes_energy_forces
from ..parallel import multihost
from ..parallel.data_parallel import make_matpes_dp_step, microbatches, rank_seed
from ..parallel.pipeline import (make_dp_pipe_mesh, make_pipeline_matpes_step,
                                 pipeline_energy_forces)
from ..parallel.sharding import make_composite_matpes_step, make_composite_mesh
from ..utils.logging import RunLogger
from ..utils.precision import full_f32_products
from .checkpoint import CheckpointManager, install_sigterm_checkpoint
from .schedules import warmup_cosine
from .trainer import GuardedAdamW, create_train_state, make_matpes_train_step

__all__ = ["main", "evaluate", "build_model", "build_eval_model", "load_data", "parse_mesh",
           "CONFIGS"]

CONFIGS = {
    "default": mp_cfg.config,
    "debug": mp_cfg.config_debug,
    "no-attn-norm": mp_cfg.config_no_attn_norm,
    "phi-every-layer": mp_cfg.config_phi_every_layer,
    "baseline": mp_cfg.config_baseline_efv2,
    "synthetic": mp_cfg.synthetic,
    "synthetic-convergence": mp_cfg.config_synthetic_convergence,
    "fixture": mp_cfg.config_fixture,
}


def build_model(cfg: dict, mixed_precision: bool) -> EquiformerV2MatPES:
    """The model of every model key of ``cfg`` (a missing key raises
    ``KeyError``), in the layout of ``cfg``'s ``uniform_blocks`` /
    ``fixed_degree`` (both True when absent, as the JAX CLI reads them)."""
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
        normalize_attn_output=bool(cfg["normalize_attn_output"]),
        use_phi_every_layer=bool(cfg["use_phi_every_layer"]),
        uniform_blocks=bool(cfg.get("uniform_blocks", True)),
        fixed_degree=bool(cfg.get("fixed_degree", True)),
        remat=bool(cfg.get("remat", False)),
    )


def build_eval_model(cfg: dict) -> EquiformerV2MatPES:
    """The float32 model of a checkpoint's config, dropout off, no remat
    (evaluation differentiates once and keeps no graph, so a recompute
    would only add a forward).  A config the JAX package wrote lacks the
    port's construction keys, which then take ``configs/matpes.py``'s
    values."""
    return build_model({"conv_fused": mp_cfg.config["conv_fused"],
                        "wigner_rep": mp_cfg.config["wigner_rep"], **cfg,
                        "alpha_drop": 0.0, "drop_path_rate": 0.0, "remat": False}, False)


def load_data(cfg: dict):
    """(train, val, test, stats) of a config: the synthetic LJ crystals
    (val and test are one set, sharing the train normalization) or the
    MatPES file the config names.  A missing MatPES file stops the program
    with a message naming it."""
    if cfg.get("synthetic"):
        train = SyntheticCrystals(n_samples=cfg.get("max_train") or 64)
        val = SyntheticCrystals(n_samples=cfg.get("max_val") or 16, seed=1,
                                stats=train.stats)
        return train, val, val, {"energy_mean": 0.0, "energy_std": 1.0}
    for key in ("data_path", "split_path"):
        if cfg.get(key) and not os.path.exists(cfg[key]):
            raise SystemExit(f"MatPES {key} not found: {cfg[key]} (relative to the "
                             "working directory)")
    return load_matpes(cfg["data_path"], cfg.get("split_path"), cfg.get("cache_dir"),
                       cfg.get("max_train"), cfg.get("max_val"), cfg.get("max_test"))


@torch.no_grad()
def evaluate(model, params: dict, loader, energy_std: float, device,
             mesh=None) -> tuple[float, float]:
    """Energy MAE (meV/atom) and force MAE (meV/A) with ``params`` (the EMA
    weights), denormalized (reference test_MatPES.py:89-152); no stress,
    as in the JAX package.  ``mesh``: a ``parallel/pipeline.py:PipeMesh``
    whose stages hold the model (every rank of the row must call this)."""
    model.eval()
    e_err = f_err = 0.0
    e_cnt = f_cnt = 0
    for pb in loader:
        batch = as_tensors(pb, device)
        with full_f32_products():
            if mesh is None:
                outs = matpes_energy_forces(model, batch, params=params)
            else:
                outs = pipeline_energy_forces(model, [batch], mesh, params)[0]
        e_err += (outs["energy"][:, 0] - batch["energy"]).abs().sum().item()
        e_cnt += batch["energy"].shape[0]
        m = batch["node_mask"]
        f_err += (outs["forces"][m] - batch["forces"][m]).abs().sum().item()
        f_cnt += 3 * int(m.sum())
    return (e_err / max(e_cnt, 1) * energy_std * 1000.0,
            f_err / max(f_cnt, 1) * energy_std * 1000.0)


def parse_mesh(spec: str) -> dict:
    """``{"data": D, "model": M, "pipe": P, "sp": bool}`` of
    ``--mesh data=D[,model=M|pipe=P][,sp]`` (an axis left out is 1, as in
    the JAX CLI, which also refuses pipe and model together)."""
    axes = {"data": 1, "model": 1, "pipe": 1, "sp": False}
    for part in (p.strip() for p in spec.split(",")):
        key, sep, value = part.partition("=")
        if part == "sp":
            axes["sp"] = True
        elif sep and key.strip() in ("data", "model", "pipe") and value.strip().isdigit():
            axes[key.strip()] = int(value)
        else:
            raise SystemExit(f"--mesh {spec}: cannot read {part!r} "
                             "(data=D[,model=M|pipe=P][,sp])")
    if axes["pipe"] > 1 and axes["model"] > 1:
        raise SystemExit(f"--mesh {spec}: pipe and model axes cannot be combined")
    if min(axes["data"], axes["model"], axes["pipe"]) < 1:
        raise SystemExit(f"--mesh {spec}: data, model and pipe must be at least 1")
    return axes


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
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group of RANK / WORLD_SIZE / MASTER_ADDR env vars "
                         "(no-op single-process); shard data per rank, write logs/checkpoints "
                         "on rank 0 only (reference train_oc20v2_parallel.py:34-54,334-349,"
                         "513-535)")
    ap.add_argument("--mesh", default=None, metavar="data=D[,model=M|pipe=P][,sp]",
                    help="train with a sharded step over the processes: 'data=4' is 4-way DP "
                         "(4 microbatches/step), 'data=4,model=2' adds Megatron-style TP (+EP "
                         "for MoE) over model ranks; ',sp' shards the edge axis too; "
                         "'data=2,pipe=2' instead runs DP x GPipe pipeline parallelism over "
                         "the layer stack (requires scan_layers=True, num_layers %% pipe == "
                         "0).  Omitted = single-device step.")
    args = ap.parse_args(argv)
    cfg = {**CONFIGS[args.config], **(overrides or {})}
    if args.epochs is not None:
        cfg["epochs"] = args.epochs
    mesh_spec = parse_mesh(args.mesh) if args.mesh else None
    data = mesh_spec["data"] if mesh_spec else None
    model_size = mesh_spec["model"] if mesh_spec else 1
    pipe = mesh_spec["pipe"] if mesh_spec else 1
    if pipe > 1 and not cfg.get("scan_layers"):
        raise SystemExit("--mesh pipe= requires scan_layers=True")
    if pipe > 1 and cfg.get("regress_stress"):
        raise SystemExit("--mesh pipe= does not support stress yet")
    inner_ckpt = bool(cfg.get("inner_ckpt", False))
    if pipe > 1 and inner_ckpt:
        raise SystemExit("--mesh pipe= does not support inner_ckpt (the pipelined step "
                         "rematerializes per block with remat=True)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (pass --device cpu to train on the CPU)")
    owns_group = args.multihost and not dist.is_initialized()
    if args.multihost and multihost.initialize_from_env(device=args.device) \
            and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    world, rank, primary = (multihost.process_count(), multihost.process_index(),
                            multihost.is_primary())
    mesh = None
    split, axis = max((model_size, "model"), (pipe, "pipe"))
    if split > 1:
        if world % split:
            raise SystemExit(f"--mesh {args.mesh}: {axis}={split} needs a multiple of "
                             f"{split} processes ({world} running): start "
                             f"{split} x the data rows with --multihost, e.g. torchrun "
                             f"--nproc_per_node {split}")
        if data % (world // split):
            raise SystemExit(f"--mesh {args.mesh}: data={data} is not a multiple of the "
                             f"{world // split} data rows of {world} processes")
        mesh = (make_composite_mesh(model_size) if axis == "model"
                else make_dp_pipe_mesh(world // pipe, pipe))
    elif world > 1 and (data is None or data % world):
        raise SystemExit(f"{world} processes need --mesh data=N with N a multiple of {world}")
    # the data shards: one per data row (the ranks of a row read the same)
    shards, shard_id = (mesh.data, mesh.data_index) if mesh else (world, rank)
    mixed_precision = bool(args.mixed_precision or cfg.get("mixed_precision", False))

    train_ds, val_ds, _, stats = load_data(cfg)
    uniform = cfg.get("uniform_blocks", True)
    fixed_degree = cfg.get("fixed_degree", True)
    n_pad, e_pad = infer_pad_sizes(train_ds, cfg["cutoff"], cfg["max_neighbors"],
                                   cfg["batch_size"], uniform=uniform,
                                   fixed_degree=fixed_degree)

    def loader(ds, shuffle, shards=(1, 0)):
        return PaddedLoader(ds, cfg["batch_size"], cfg["cutoff"], cfg["max_neighbors"],
                            n_pad, e_pad, shuffle=shuffle, seed=cfg["seed"], uniform=uniform,
                            fixed_degree=fixed_degree, num_shards=shards[0],
                            shard_id=shards[1])

    train_loader, val_loader = loader(train_ds, True, (shards, shard_id)), loader(val_ds, False)

    model = build_model(cfg, mixed_precision)
    init_weights(model, torch.Generator().manual_seed(cfg["seed"]))
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    if primary:
        print(f"model params: {n_params / 1e6:.2f}M  pads: n={n_pad} e={e_pad}  "
              f"device {device}  {'bf16' if mixed_precision else 'f32'} compute"
              + (f"  data-parallel: data={data} over {world} processes"
                 if data and not mesh else ""))
        if mesh and pipe > 1:
            print(f"pipeline step: data={data} pipe={pipe} ({data} microbatches/step)")
        elif mesh:
            print(f"mesh step: data={data} model={model_size} sp={mesh_spec['sp']} "
                  f"({data} microbatches/step, {world} processes)")

    steps_per_epoch = max(len(train_loader), 1)
    sched = warmup_cosine(cfg["lr"], cfg["warmup_epochs"] * steps_per_epoch,
                          cfg["epochs"] * steps_per_epoch)
    opt = GuardedAdamW(model.named_parameters(), sched, cfg["weight_decay"],
                       cfg["grad_clip"])
    state = create_train_state(model, opt)
    ckpt = CheckpointManager(cfg["run_dir"], {**cfg, **stats}, primary=primary)
    if args.checkpoint:
        meta = ckpt.restore(args.checkpoint, state)
        if primary:
            print(f"resumed from {args.checkpoint}: epoch {meta.get('epoch')}, "
                  f"step {state.step}")
    logger = RunLogger(cfg["run_dir"], cfg, primary=primary)
    # a pipeline stage draws its own dropout masks; the ranks of a composite
    # row draw the same
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(cfg["seed"], rank if pipe > 1 else shard_id))
    w_stress = cfg["w_stress"] if cfg["regress_stress"] else 0.0
    if mesh is not None:
        if pipe > 1:
            step_fn = make_pipeline_matpes_step(state, mesh, data, cfg["w_energy"],
                                                cfg["w_force"], cfg["ema_decay"], gen)
        else:
            step_fn = make_composite_matpes_step(state, mesh, data, cfg["w_energy"],
                                                 cfg["w_force"], w_stress, mesh_spec["sp"],
                                                 cfg["ema_decay"], gen, inner_ckpt)
        n_local = data // shards
        n_steps = len(train_loader.indices) // shards // cfg["batch_size"] // n_local

        def batches(loader):
            return microbatches(loader, device, n_local, n_steps)
    elif data is None:
        step_fn = make_matpes_train_step(state, cfg["w_energy"], cfg["w_force"], w_stress,
                                         cfg["ema_decay"], gen, inner_ckpt)

        def batches(loader):
            return (as_tensors(pb, device) for pb in loader)
    else:
        step_fn = make_matpes_dp_step(state, data, cfg["w_energy"], cfg["w_force"],
                                      w_stress, cfg["ema_decay"], gen, inner_ckpt)
        n_local = data // world
        n_steps = len(train_loader.indices) // world // cfg["batch_size"] // n_local

        def batches(loader):
            return microbatches(loader, device, n_local, n_steps)
    # a sharded state's checkpoint needs every rank: no emergency write
    emergency = primary and mesh is None
    previous = install_sigterm_checkpoint(lambda: state, ckpt) if emergency else None
    try:
        _train(cfg, state, step_fn, batches, train_loader, val_loader, stats, ckpt, logger,
               n_params, device, primary, mesh if pipe > 1 else None)
    finally:
        if emergency:
            signal.signal(signal.SIGTERM, previous)
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return state


def _train(cfg, state, step_fn, batches, train_loader, val_loader, stats, ckpt, logger,
           n_params, device, primary, pipe_mesh=None) -> None:
    """The epoch loop: train on ``batches(train_loader)``, evaluate with the
    EMA weights every ``eval_every`` epochs and after the last (through the
    pipeline of ``pipe_mesh``), checkpoint, log (the primary process
    prints)."""
    best_val = np.inf
    nan_batches = 0
    e_mae = f_mae = float("inf")   # the last evaluation's
    for epoch in range(cfg["epochs"]):
        train_loader.set_epoch(epoch)
        t0 = time.time()
        losses, stress = [], []
        for batch in batches(train_loader):
            loss, metrics = step_fn(batch)
            loss = float(loss)
            if not metrics["accepted"] or not np.isfinite(loss):
                nan_batches += 1  # the guard skipped this update
            else:
                losses.append(loss)
                if "stress_l1" in metrics:
                    stress.append(float(metrics["stress_l1"]))
        if (epoch + 1) % cfg.get("eval_every", 1) == 0 or epoch == cfg["epochs"] - 1:
            e_mae, f_mae = evaluate(state.model, state.ema, val_loader,
                                    stats["energy_std"], device, pipe_mesh)
        dt = time.time() - t0
        extra = {"train_stress_l1": float(np.mean(stress))} if stress else {}
        if primary:
            print(f"epoch {epoch}: loss={np.mean(losses) if losses else float('nan'):.4f} "
                  + "".join(f"{k}={v:.4f} " for k, v in extra.items())
                  + f"E={e_mae:.1f} meV/atom F={f_mae:.1f} meV/A "
                  f"nan_skipped={nan_batches} ({dt:.1f}s)")
            if train_loader.overflow_batches:
                print(f"  WARNING: {train_loader.overflow_batches} batches overflowed the "
                      f"static pads this epoch (dropped {train_loader.overflow_atoms} atoms / "
                      f"{train_loader.overflow_edges} edges); raise n_pad/e_pad")
        logger.log_epoch(epoch, {
            "train_loss": float(np.mean(losses)) if losses else float("nan"), **extra,
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
