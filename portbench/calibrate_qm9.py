"""Readings that the QM9 cell's correctness limits are set from (not part of
a run); ``calibrate.py --what program`` gives the program's own.

    python3 portbench/calibrate_qm9.py --workload qm9-train-b64 --what control --seeds 1,2,3
    python3 portbench/calibrate_qm9.py --workload qm9-train-b64 --what half-batch --seeds 1,2,3
    python3 portbench/calibrate_qm9.py --workload qm9-train-b64 --what k3-tf32 --seeds 1,2,3

``control``: the plain reference with TF32 products (geometry included),
the precision below the configuration's float32, in the program's place,
against the float32 reference, on the cell's sizes and inputs.
``half-batch``: the program's step with a loss over the first half of each
batch (a planted fault).  ``k3-tf32``: the program's step with K3 computing
in single TF32 (its operands rounded to TF32, the small parts of the
3xTF32 split left out; a planted fault).  One JSON line per seed, then the
largest and the smallest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness.common import PKG  # noqa: E402


def control(cell, seed: int, device) -> dict:
    """TF32 reference against the float32 reference on the first batches."""
    from portbench.entries.train import build, compare, norms
    from portbench.harness.common import draw_weights, reference_model
    from portbench.reference.model import Numerics
    from portbench.reference.qm9 import Trainer
    from portbench.traffic import molecules

    cfg, tr = cell.config, cell.traffic
    opt, k, cutoff = cfg["train"], cfg["max_neighbors"], cfg["model"]["cutoff"]
    model = build(cfg, "cpu")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    w0 = {n: t.cpu() for n, t in draw_weights(shapes, seed, device).items()}
    pool = molecules.generate(tr, seed)
    order = np.random.default_rng(seed).permutation(len(pool))
    B, block = int(tr["structures_per_step"]), int(tr["reference_graphs_per_block"])
    ref = Trainer(reference_model(cfg), w0, opt, cutoff, k, device, block)
    low = Trainer(reference_model(cfg, Numerics("tf32", geometry=True)), w0, opt, cutoff, k,
                  device, block)
    for i in range(int(tr["check_steps"])):
        batch = [pool[j] for j in order[i * B:(i + 1) * B]]
        ref.step(batch)
        low.step(batch)
    first = {n: float(g.norm()) for n, g in low.first_grad.items()}
    numbers, info = compare(low.losses, first, norms(low.W, w0, device),
                            norms(low.ema, w0, device), ref, w0, device)
    return dict(numbers=numbers, info=info)


def half_batch(trainer_mod) -> None:
    """Patch the program's QM9 loss to leave out the second half of each batch."""
    plain = trainer_mod.qm9_loss

    def loss(pred, target, kind="l1"):
        B = target.shape[0]
        return plain(pred[:B // 2], target[:B // 2], kind)

    trainer_mod.qm9_loss = loss


def k3_single_tf32(k3) -> None:
    """Patch K3 (``ops/cuda/so2conv.py``) to compute in single TF32: its A
    operands rounded to TF32 and the B operands' small parts zero, so each
    product is one TF32 product."""
    plain_b, plain_fwd, plain_adj = k3.b_operands, k3.fwd, k3.adj

    def b_operands(ws, adjoint):
        hi, lo = plain_b(ws, adjoint)
        return hi, None if lo is None else [torch.zeros_like(t) for t in lo]

    def fwd(x, ws, *a):
        return plain_fwd(k3.tf32_round(x), ws, *a)

    def adj(dy, dextra, ws, *a):
        return plain_adj(k3.tf32_round(dy), None if dextra is None else k3.tf32_round(dextra),
                         ws, *a)

    k3.b_operands, k3.fwd, k3.adj = b_operands, fwd, adj


def main(argv=None) -> int:
    from importlib import import_module

    from portbench.harness.common import Phases, load_cell
    from portbench.harness.run import run_entry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("control", "half-batch", "k3-tf32"), required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(a.workload)
    if a.what == "half-batch":
        half_batch(import_module(f"{PKG}.train.trainer"))
    elif a.what == "k3-tf32":
        k3_single_tf32(import_module(f"{PKG}.ops.cuda.so2conv"))
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        if a.what == "control":
            r = control(cell, seed, "cuda")
        else:
            r = run_entry(cell, seed, 0.0, False, "cuda", Phases(time.perf_counter()))
        rows.append(r["numbers"])
        print(json.dumps({"workload": a.workload, "what": a.what, "seed": seed,
                          "numbers": r["numbers"], "info": str(r["info"]),
                          "seconds": time.perf_counter() - t}), flush=True)
    keys = rows[0].keys()
    print(json.dumps({"workload": a.workload, "what": a.what, "seeds": len(rows),
                      "max": {k: max(r[k] for r in rows) for k in keys},
                      "min": {k: min(r[k] for r in rows) for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
