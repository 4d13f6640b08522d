"""Readings that the correctness limits are set from (not part of a run).

    python3 portbench/calibrate.py --workload NAME --what control --seeds 1,2,3
    python3 portbench/calibrate.py --workload NAME --what program --seeds 1,2,3
    python3 portbench/calibrate.py --workload NAME --what half-batch --seeds 1,2,3

``control``: the plain reference in the next precision below the one the
configuration states (training: fp8 e4m3 products with one scale per
tensor, for bf16; serving: TF32 products, geometry included, for float32
with TF32 off) in the program's place, against the float32 reference, on the
cell's own sizes and inputs.  ``program``: the program's numbers alone
(set-up, one window step, the comparison).  ``half-batch``: a training step
whose loss leaves out the second half of each batch and takes its means over
the first (a planted fault).  One JSON line per seed, then the largest and
the smallest reading of each number.
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


def control_train(cell, seed: int, device) -> dict:
    """fp8 reference against the float32 reference on the first batches."""
    from portbench.entries.train import build, compare, norms
    from portbench.harness.common import draw_weights, reference_model
    from portbench.reference.model import Numerics
    from portbench.reference.train import Trainer
    from portbench.traffic import labelled_pool

    cfg, tr = cell.config, cell.traffic
    mk, opt = cfg["model"], cfg["train"]
    k = cfg["max_neighbors"]
    model = build(cfg, "cpu")
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    w0 = {n: t.cpu() for n, t in draw_weights(shapes, seed, device).items()}
    pool = labelled_pool.generate(tr, seed)
    rng = np.random.default_rng(seed)
    B = int(tr["structures_per_step"])
    order = rng.permutation(len(pool))
    block = int(tr["reference_graphs_per_block"])
    ref = Trainer(reference_model(cfg), w0, opt, mk["cutoff"], k, device, block)
    low = Trainer(reference_model(cfg, Numerics("fp8")), w0, opt, mk["cutoff"], k, device,
                  block)
    for i in range(int(tr["check_steps"])):
        batch = [pool[j] for j in order[i * B:(i + 1) * B]]
        ref.step(batch)
        low.step(batch)
    first = {n: float(g.norm()) for n, g in low.first_grad.items()}
    numbers, info = compare(low.losses, first, norms(low.W, w0, device),
                            norms(low.ema, w0, device), ref, w0, device)
    return dict(numbers=numbers, info=info)


def control_serve(cell, seed: int, device) -> dict:
    """TF32 reference against the float32 reference on the sampled requests."""
    from portbench.entries.serve import reference_request
    from portbench.harness.common import draw_weights, program_model, reference_model
    from portbench.reference.model import Numerics
    from portbench.traffic import mixed_requests

    cfg, tr = cell.config, cell.traffic
    mk, k = cfg["model"], cfg["max_neighbors"]
    model = program_model(cfg, "float32", cfg["serve"]["layout"])
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    W = draw_weights(shapes, seed, device)
    n_req = int(tr["requests"])
    requests = mixed_requests.generate(tr, seed, n_req)
    atoms = [sum(len(s["positions"]) for s in r) for r in requests]
    rng = np.random.default_rng(seed)
    largest = int(np.argmax(atoms))
    others = [i for i in range(n_req) if i != largest]
    sample = [largest] + [others[j] for j in rng.choice(len(others),
                                                        int(tr["check_requests"]) - 1,
                                                        replace=False)]
    ref, low = reference_model(cfg), reference_model(cfg, Numerics("tf32", geometry=True))
    e_gap = f_gap = e_scale = 0.0
    for i in sample:
        e_r, f_r = reference_request(ref, W, requests[i], mk["cutoff"], k, device)
        e_l, f_l = reference_request(low, W, requests[i], mk["cutoff"], k, device)
        e_scale = max(e_scale, float(np.abs(e_r).max()))
        e_gap = max(e_gap, float(np.abs(e_l - e_r).max()))
        f_gap = max(f_gap, float(np.linalg.norm(f_l - f_r) / np.linalg.norm(f_r)))
    return dict(numbers={"energy_gap": e_gap / e_scale, "force_gap": f_gap},
                info=dict(sample_atoms=[atoms[i] for i in sample]))


def half_batch(trainer_mod, forces: str):
    """Patch the program's loss to leave out the second half of each batch
    (``forces``: the configuration's ``outputs.forces``: by autograd, the
    MatPES loss; from a head, the OC20 loss)."""
    if forces == "gradient":
        plain = trainer_mod.matpes_loss

        def loss(outs, batch, *a, **kw):
            B = batch["energy"].shape[0]
            keep = batch["graph_idx"] < B // 2
            outs = dict(outs, energy=outs["energy"][:B // 2])
            batch = dict(batch, energy=batch["energy"][:B // 2],
                         node_mask=batch["node_mask"] & keep)
            return plain(outs, batch, *a, **kw)

        trainer_mod.matpes_loss = loss
    else:
        plain = trainer_mod.oc20_loss

        def loss(e_pred, e_tgt, f_pred, f_tgt, node_mask, *a, **kw):
            B = e_tgt.shape[0]
            n = node_mask.shape[0]
            keep = torch.arange(n, device=node_mask.device) < n // 2
            return plain(e_pred[:B // 2], e_tgt[:B // 2], f_pred, f_tgt, node_mask & keep,
                         *a, **kw)

        trainer_mod.oc20_loss = loss


def main(argv=None) -> int:
    from importlib import import_module

    from portbench.harness.common import Phases, load_cell
    from portbench.harness.run import run_entry

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("control", "program", "half-batch"), required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(a.workload)
    train = cell.traffic["entry"] == "train"
    if a.what == "half-batch":
        half_batch(import_module(f"{PKG}.train.trainer"), cell.config["outputs"]["forces"])
    rows = []
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        if a.what == "control":
            r = (control_train if train else control_serve)(cell, seed, "cuda")
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
