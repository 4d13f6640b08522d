"""Percent of K3-dW's bound (K3's weight gradient, one call per SO(2)-conv
site a training step) that the device time of its kernels in the profiled
slice reaches: every operation whose name holds ``so2conv_dw`` (the kernel
and its reduce).  None when no such kernel ran or the configuration is not
counted by ``counts/qm9.py``.

The bound counts the work at each unit's real edge count (the fourth field
of ``slice_shapes``, the batch's ``edge_mask.sum()``): for each of the 2 x
num_layers sites, the larger of its GEMMs' 2 E_real x (packed weight
entries) FLOPs at the compute type's tensor-core rate (3xTF32 for float32,
``counts/ops.py``'s ``f32_tc`` route; bf16) and the bytes of X, Y (with the
extra columns) and dW moved once at 3.35 TB/s.  Counted at the real rows,
the reading is the same work whatever computes it: a kernel that reduced
every padded row would read about the real rows' share of what one that
skips the padding reads."""

from portbench.counts.ops import BYTES, Op
from portbench.counts.qm9 import _dims, _k3_weights, _so2conv_sites

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels"
MOVES = "train_graphs_per_s"
KERNELS = ("so2conv_dw",)


def _ops(model: dict, compute: str, e_real: int) -> list[Op]:
    d = _dims(model)
    K, nb = d["Kr"], BYTES[compute]
    route = "bf16" if compute == "bfloat16" else "f32_tc"
    out = []
    for cin, cout, extra in _so2conv_sites(model) * model["num_layers"]:
        w = _k3_weights(d, cin, cout, extra)
        nbytes = nb * (e_real * K * (cin + cout) + e_real * extra + w)
        out.append(Op(nbytes, 2.0 * e_real * w, route))
    return out


def read(r):
    if r.slice is None or r.mode != "train" or r.counts != "qm9":
        return None
    t = r.slice.kernel_s(KERNELS)
    if t <= 0:
        return None
    bound = sum(r.ops.bound_seconds(_ops(r.model, r.compute, e_real))
                for _, _, _, e_real in r.slice_shapes)
    return 100.0 * bound / t
