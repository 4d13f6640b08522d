"""Percent of the profiled slice's span in which no device operation ran."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "train_graphs_per_s"


def read(r):
    return r.idle()
