"""Learning-rate schedule of the reference trainers, per step.

The port's copy of the JAX package's train/schedules.py at its defaults:
linear warmup (factor ``START_FACTOR`` -> 1 over ``warmup_steps``) then
cosine annealing to zero at ``total_steps``, as a plain function of the step.
"""

from __future__ import annotations

import math

__all__ = ["warmup_cosine", "START_FACTOR"]

START_FACTOR = 0.01


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int):
    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * (START_FACTOR
                              + (1.0 - START_FACTOR) * step / max(warmup_steps, 1))
        progress = min(max((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

    return schedule
