"""Device operations (kernels, copies, sets) per request in the profiled slice."""

UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "model"
MOVES = "serve_p95_ms"


def read(r):
    return r.launches()
