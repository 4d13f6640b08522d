"""Percent of the S2 activations' bound (counts/ops.py:s2act_ops at the slice's
padded shapes: K2a, K2b, K2c each reading its inputs and writing its outputs
once, or their FLOPs at the compute type's tensor-core rate) that the device
time of the ``s2act`` kernels in the profiled slice reaches; None when none
ran."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "serve_structures_per_s"


def read(r):
    return r.roofline("s2act", ("s2act",))
