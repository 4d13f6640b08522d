"""Mean wait of a window step on the padded loader's next batch (host clock around
``next()``), in ms: the share of the step that the neighbour search and
collate on the loader's thread do not hide."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "data"
MOVES = "train_graphs_per_s"


def read(r):
    return 1e3 * sum(r.loader_wait_s) / len(r.loader_wait_s) if r.loader_wait_s else None
