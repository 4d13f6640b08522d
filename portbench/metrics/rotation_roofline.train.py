"""Percent of the rotations' bound (counts/ops.py:rotation_ops at the slice's
padded shapes: features read and written once, or the FLOPs at 67 TFLOP/s,
whichever is longer) that the device time of the rotation kernels (K1
``pairs_kernel``, K4 ``rot_kernel``) in the profiled slice reaches; None
when neither ran."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_graphs_per_s"


def read(r):
    return r.roofline("rotation", ("pairs_kernel", "rot_kernel"))
