"""What every cell shares: the files a cell is made of, the card, the
weights, the JAX guard and the result line."""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

__all__ = ["ROOT", "BENCH", "FORBIDDEN", "PKG", "LAYOUTS", "Cell", "load_cell", "draw_weights",
           "card_line", "jax_loaded", "load_metric", "emit", "check_limits", "leaf_gap", "leaf_gaps",
           "program", "program_model", "reference_model", "Phases", "graph_mismatch"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
# modules that may not be loaded in a run (compared by whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "equivarianttransformermpnn4quantumcomputations_tpu")
# the program under test
PKG = "equivarianttransformermpnn4quantumcomputations_tpu_torch"
# a configuration's layout name -> the program's model fields
LAYOUTS = {"fixed_degree": dict(uniform_blocks=True, fixed_degree=True),
           "ragged": dict(uniform_blocks=False, fixed_degree=False)}


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its configuration, traffic mix,
    limits and metric entries."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, cell_metrics: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; one without, in
    every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in cell_metrics


def load_cell(name: str, manifest: Path | None = None) -> Cell:
    """The cell ``name`` of the manifest (the repository's ``BENCHMARK.json``)."""
    man = _json(manifest or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of {sorted(cells)}")
    w = cells[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    config = _json(ROOT / cfgs[w["config"]]["file"])
    traffic = _json(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _json(BENCH / "limits" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e, per_layer)


def load_metric(name: str):
    """The reader module of the per-layer metric ``name`` (metrics/<name>.py)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def program(dotted: str):
    """The program's object at ``module.path.name`` (under the package)."""
    mod, attr = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(f"{PKG}.{mod}"), attr)


def program_model(config: dict, compute_dtype: str, layout: str):
    """The program's model of a configuration, built on the host (its
    constructors turn tables into numpy): the class that ``program.model``
    names, with the configuration's model keys less those the class fixes
    itself (``program.model_fixes``), the compute type and the layout."""
    prog = config["program"]
    fixes = set(prog.get("model_fixes", ()))
    keys = {k: v for k, v in config["model"].items() if k not in fixes}
    return program(prog["model"])(**keys, compute_dtype=getattr(torch, compute_dtype),
                                  **LAYOUTS[layout])


def reference_model(config: dict, numerics=None):
    """The plain reference of a configuration: ``reference/<reference>.py``'s
    ``Model`` on the model keys and outputs (``numerics``: the control's)."""
    mod = importlib.import_module(f"portbench.reference.{config.get('reference', 'model')}")
    extra = () if numerics is None else (numerics,)
    return mod.Model(config["model"], config["outputs"], *extra)


class Phases:
    """Host-clock marks of set-up's parts, from the process's start."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start
        self.marks: list[tuple[str, float]] = []

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        self.marks.append((name, round(t - self.last, 3)))
        self.last = t

    def __str__(self) -> str:
        return ", ".join(f"{n} {s}" for n, s in self.marks)


def graph_mismatch(pb, structures: list, cutoff: float, k: int) -> int:
    """Graphs of the program's padded batch ``pb`` (any layout) whose atoms or
    real edges differ from the reference's neighbour list of the same
    structure; ``structures``: (positions, cell) of each graph in order."""
    from ..reference.neighbors import edge_key, neighbor_list

    real = np.flatnonzero(pb.node_mask)
    gi = np.asarray(pb.graph_idx)
    m = np.asarray(pb.edge_mask)
    src, dst, sh = pb.edge_src[m], pb.edge_dst[m], pb.edge_shift[m]
    bad = 0
    for b, (pos, cell) in enumerate(structures):
        nodes = real[gi[real] == b]
        off = int(nodes[0]) if len(nodes) else 0
        e = gi[dst] == b
        got = edge_key(src[e] - off, dst[e] - off, sh[e])
        want = edge_key(*neighbor_list(pos, cell, cutoff, k))
        bad += int(len(nodes) != len(pos) or got.shape != want.shape
                   or not np.array_equal(got, want))
    return bad


def _init_rule(name: str, shape: tuple) -> tuple[str, float]:
    """("zeros" | "ones" | "normal" | "uniform", scale) of one leaf, by its name
    and shape: biases 0, norm scales 1, the atom embedding normal(1/sqrt(C)),
    the atom-edge embeddings uniform(+-1e-3), the attention dots
    uniform(+-1/sqrt(A)), every matrix normal(1/sqrt(fan_in)) (fan-in: the
    last axis of a dense [out, in] weight, else the second to last)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or leaf.startswith("b_m"):
        return "zeros", 0.0
    if "norm" in name.rsplit(".", 2)[-2] or "norms" in name:
        return "ones", 1.0
    if "sphere_embedding" in name:
        return "normal", shape[-1] ** -0.5
    if "embedding" in name:
        return "uniform", 1e-3
    if leaf == "alpha_dot":
        return "uniform", shape[-1] ** -0.5
    if leaf == "weight" and len(shape) == 2:
        return "normal", shape[-1] ** -0.5
    return "normal", shape[-2] ** -0.5


def draw_weights(shapes: dict, seed: int, device) -> dict:
    """Float32 weights for every name -> shape of a state_dict, drawn on
    ``device`` from ``seed`` in two calls (one normal, one uniform)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    rules = {k: _init_rule(k, tuple(s)) for k, s in shapes.items()}
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    n_norm = sum(sizes[k] for k, (r, _) in rules.items() if r == "normal")
    n_unif = sum(sizes[k] for k, (r, _) in rules.items() if r == "uniform")
    normal = torch.randn(n_norm, generator=gen, device=device)
    unif = torch.rand(n_unif, generator=gen, device=device) * 2 - 1
    out, io, iu = {}, 0, 0
    for k, s in shapes.items():
        rule, scale = rules[k]
        n = sizes[k]
        if rule == "normal":
            out[k] = (normal[io:io + n] * scale).reshape(s)
            io += n
        elif rule == "uniform":
            out[k] = (unif[iu:iu + n] * scale).reshape(s)
            iu += n
        else:
            out[k] = torch.full(tuple(s), 1.0 if rule == "ones" else 0.0, device=device)
    return out


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or what failed."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def jax_loaded() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), the median
    leaf's norm(ref)); ``keep``: the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names]))
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med, 1e-30) for k in names}


def leaf_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's gap (``leaf_gaps``) and its name."""
    gaps = leaf_gaps(prog, ref, keep)
    at = max(gaps, key=gaps.get, default="")
    return (gaps[at] if at else 0.0), at


def check_limits(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number within its limit (a missing or non-finite number fails)."""
    out, ok = {}, True
    for k, lim in limits.items():
        v = numbers.get(k, float("nan"))
        good = math.isfinite(v) and v <= lim
        ok &= good
        out[k] = {"value": v, "limit": lim}
    return ok, out


def emit(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
         checks: dict, breakdown: dict | None = None) -> None:
    """The compared numbers as the last lines on stderr, then the result line
    as the last line on stdout."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)

