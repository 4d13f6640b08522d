"""Host time per request spent in the program's outermost ``etq.sync.*``
spans: the waits for the stream to drain, in ms."""

from portbench.harness.spans import sync_wait_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "model"
MOVES = "serve_p95_ms"


def read(r):
    return sync_wait_ms(r.slice)
