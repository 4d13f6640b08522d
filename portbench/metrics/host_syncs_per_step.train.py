"""Host syncs per training step: the program's ``etq.sync.*`` spans in the
profiled slice (each blocking upload, copy back or host read of a device
value sits in one)."""

from portbench.harness.spans import syncs

UNIT = "syncs"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "step"
MOVES = "train_graphs_per_s"


def read(r):
    return syncs(r.slice)
