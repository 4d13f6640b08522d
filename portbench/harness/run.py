"""One run of a cell: the entry's set-up, window and reference, then the
metrics, the JAX guard, the comparison and the result line."""

from __future__ import annotations

import importlib
import sys

import torch

from .common import Phases, card_line, check_limits, emit, jax_loaded, load_metric

__all__ = ["run_cell", "run_entry"]


def run_entry(cell, seed: int, seconds: float, trace: bool, device, phases: Phases) -> dict:
    """The entry's own results (no result line); ``phases``: set-up's marks
    from the process's start."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = importlib.import_module(f"portbench.entries.{cell.traffic['entry']}")
    return entry.run(cell, seed, seconds, trace, device, phases)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, phases: Phases) -> int:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        phases.mark("cuda init")
    r = run_entry(cell, seed, seconds, trace, device, phases)
    if dev.type == "cuda":   # after the window: nvidia-smi is no part of set-up
        print(f"card: {card_line()}", file=sys.stderr)
    bad = jax_loaded()
    if bad:
        print(f"portbench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    print(f"info: {r['info']}", file=sys.stderr)
    ok, checks = check_limits(r["numbers"], cell.limits)
    rd = r["readings"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(r["peak"])}
    breakdown = None
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(rd)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        sl = rd.slice
        device_info.update(busy_s=sl.busy_s, window_s=sl.window_s)
        breakdown = sl.breakdown()
        print(f"slice: {sl.units} unit(s), {len(sl.device)} device ops, wall {sl.wall_s}, "
              f"buckets {sl.buckets()}", file=sys.stderr)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in r["metrics"].items()
                   if k in units}
    emit(ok, r["attempted"], r["failed"], metrics, device_info, checks, breakdown)
    return 0
