"""Host syncs per request: the program's ``etq.sync.*`` spans in the
profiled slice (the uploads, the Wigner tables' constants, the copies
back)."""

from portbench.harness.spans import syncs

UNIT = "syncs"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "model"
MOVES = "serve_p95_ms"


def read(r):
    return syncs(r.slice)
