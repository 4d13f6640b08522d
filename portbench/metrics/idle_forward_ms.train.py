"""Device-idle ms per step inside the program's ``etq.step.cast`` and
``etq.step.forward`` spans (the bf16 copies of the masters, the model and
the force pass), by overlap with the slice's idle intervals."""

from portbench.harness.spans import idle_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "step"
MOVES = "train_graphs_per_s"


def read(r):
    return idle_ms(r.slice, ("etq.step.cast", "etq.step.forward"))
