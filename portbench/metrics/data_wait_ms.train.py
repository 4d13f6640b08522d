"""Time a step waits on the padded loader's next batch, in ms per step: the
program's ``etq.data.wait`` span around the consumer's queue read (the
in-program twin of ``loader_wait_ms.train``, in the profiled slice)."""

from portbench.harness.spans import span_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "data"
MOVES = "train_graphs_per_s"


def read(r):
    return span_ms(r.slice, "etq.data.wait")
