"""Device-idle ms per step inside the program's ``etq.step.update`` span
(guard, clip, AdamW in ``etq.step.adamw``, EMA in ``etq.step.ema``), by
overlap with the slice's idle intervals."""

from portbench.harness.spans import idle_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "step"
MOVES = "train_graphs_per_s"


def read(r):
    return idle_ms(r.slice, ("etq.step.update", "etq.step.adamw", "etq.step.ema"))
