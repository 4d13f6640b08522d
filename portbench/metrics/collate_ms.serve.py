"""Mean host time of a window request's ``Predictor.collate`` (the neighbour
search and the padded ragged batch), in ms, from the benchmark's wrapper."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "data"
MOVES = "serve_p95_ms"


def read(r):
    return 1e3 * sum(r.collate_s) / len(r.collate_s) if r.collate_s else None
