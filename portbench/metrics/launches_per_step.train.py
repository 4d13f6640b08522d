"""Device operations (kernels, copies, sets) per training step in the profiled
slice."""

UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "step"
MOVES = "train_graphs_per_s"


def read(r):
    return r.launches()
