"""Device-idle ms per request inside the program's ``etq.request.model``
span (the model and the force pass), by overlap with the slice's idle
intervals."""

from portbench.harness.spans import idle_ms

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "model"
MOVES = "serve_structures_per_s"


def read(r):
    return idle_ms(r.slice, ("etq.request.model",))
