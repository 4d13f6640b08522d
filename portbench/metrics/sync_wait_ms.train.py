"""Host time per training step spent in the program's outermost
``etq.sync.*`` spans: the waits for the stream to drain, in ms."""

from portbench.harness.spans import sync_wait_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "step"
MOVES = "train_graphs_per_s"


def read(r):
    return sync_wait_ms(r.slice)
