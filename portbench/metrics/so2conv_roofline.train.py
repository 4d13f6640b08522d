"""Percent of K3's bound (the configuration's counts module's ``so2conv_ops``
at the slice's padded shapes: each call's input, weights and output moved
once, or its GEMM FLOPs at the compute type's tensor-core rate, 3xTF32 for
float32, whichever is longer) that the device time of K3's kernels in the
profiled slice (``so2conv_kernel`` and its B-operand builds,
``b_operand_kernel``) reaches; None when no K3 kernel ran or the counts
module has no K3 count."""

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_graphs_per_s"
KERNELS = ("so2conv_kernel", "b_operand_kernel")


def read(r):
    if r.slice is None:
        return None
    count = getattr(r.ops, "so2conv_ops", None)
    t = r.slice.kernel_s(KERNELS)
    if count is None or t <= 0:
        return None
    bound = sum(r.ops.bound_seconds(count(r.model, r.outputs, r.mode, r.compute, n_pad, e_pad))
                for n_pad, e_pad, _, _ in r.slice_shapes)
    return 100.0 * bound / t
