"""Model FLOPs of the window's requests (counts/ops.py:model_flops: the forward
and, for forces by autograd, the force backward by the input) over their
summed latencies (host clock), as a percent of the compute type's peak
(float32 without TF32: 67 TFLOP/s)."""

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model"
MOVES = "serve_structures_per_s"


def read(r):
    return r.mfu(sum(r.service_s))
