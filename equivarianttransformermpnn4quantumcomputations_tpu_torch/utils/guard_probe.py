"""Find the first MatPES training step the guard skips, and where its NaN
arises.

    python -m equivarianttransformermpnn4quantumcomputations_tpu_torch.utils.guard_probe \
        [--config synthetic-convergence] [--device cuda|cpu]

Trains the config as train/train_matpes.py does, into ``runs/guard_probe``,
until ``GuardedAdamW`` skips a step (a non-finite gradient norm) or the
loss is not finite.  On that step's weights and batch (the skipped update
left the weights as they were) it prints: the loss, whether the outputs are
finite, the parameters whose gradient is not finite, the same on the CPU
plain path (a copy of the model and batch), and the operation that
autograd's anomaly mode names.  Without a skipped step it prints "no
skipped step".
"""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from ..models.matpes import matpes_energy_forces
from ..train import train_matpes
from ..train.trainer import matpes_loss
from .precision import full_f32_products

__all__ = ["main", "loss_gradients"]


class _Skipped(Exception):
    def __init__(self, state, batch):
        super().__init__("the guard skipped a step")
        self.state, self.batch = state, batch


def loss_gradients(model, batch: dict, w_stress: float = 0.0, anomaly: bool = False):
    """One force-training loss backward in ``train()`` mode: (loss, which
    outputs are finite, [(parameter, max |grad|)] of the non-finite
    gradients)."""
    model.zero_grad(set_to_none=True)
    model.train()
    with torch.autograd.set_detect_anomaly(anomaly), full_f32_products():
        outs = matpes_energy_forces(model, batch, create_graph=True,
                                    regress_stress=w_stress > 0.0)
        loss, _ = matpes_loss(outs, batch, 1.0, 1.0, w_stress)
        loss.backward()
    finite = {k: bool(torch.isfinite(v).all()) for k, v in outs.items()}
    bad = [(n, float(p.grad.abs().max())) for n, p in model.named_parameters()
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    return float(loss.detach()), finite, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="synthetic-convergence",
                    choices=sorted(train_matpes.CONFIGS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    make_step = train_matpes.make_matpes_train_step

    def probing_step(state, *a, **kw):
        step = make_step(state, *a, **kw)

        def run(batch):
            loss, m = step(batch)
            if not m["accepted"] or not np.isfinite(float(loss)):
                raise _Skipped(state, batch)
            return loss, m

        return run

    train_matpes.make_matpes_train_step = probing_step
    try:
        train_matpes.main(["--config", args.config, "--device", args.device],
                          overrides={"run_dir": "runs/guard_probe"})
        print("no skipped step")
        return 0
    except _Skipped as e:
        state, batch = e.state, e.batch
    finally:
        train_matpes.make_matpes_train_step = make_step
    cfg = train_matpes.CONFIGS[args.config]
    w_stress = cfg["w_stress"] if cfg["regress_stress"] else 0.0
    print(f"the guard skipped step {state.step} (after {state.optimizer.count} updates)")
    cpu_model = copy.deepcopy(state.model).to("cpu")
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    for where, model, b in ((args.device, state.model, batch), ("cpu", cpu_model, cpu_batch)):
        loss, finite, bad = loss_gradients(model, b, w_stress)
        print(f"{where}: loss {loss}, outputs finite {finite}, {len(bad)} parameters with a "
              f"non-finite gradient: {[n for n, _ in bad[:6]]}")
        try:
            loss_gradients(model, b, w_stress, anomaly=True)
            print(f"{where}: anomaly mode names no operation")
        except RuntimeError as err:
            print(f"{where}: anomaly mode: {str(err)[:200]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
