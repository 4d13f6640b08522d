"""Host time of a request's ``Predictor.collate`` (neighbour search and the
padded ragged batch), in ms per request: the program's ``etq.data.collate``
span in the profiled slice (the in-program twin of ``collate_ms.serve``)."""

from portbench.harness.spans import span_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "data"
MOVES = "serve_p95_ms"


def read(r):
    return span_ms(r.slice, "etq.data.collate")
