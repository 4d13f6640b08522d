"""Model FLOPs of the window's steps (counts/ops.py:model_flops: the forward
on the real atoms and edges times its FLOP passes, which the configuration's
outputs set: 6 with forces by autograd, 3 with a force head) over the
unprofiled window's time, as a percent of the compute type's peak (bf16
989 TFLOP/s)."""

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "step"
MOVES = "train_graphs_per_s"


def read(r):
    return r.mfu(r.window_s)
