"""The profiled slice of a ``--trace 1`` run: device operations, busy time,
idle gaps labelled by the host operation in flight, and the breakdown.

``torch.profiler`` (CPU and CUDA activities) records a short slice of steady
steps or requests after the unprofiled window; its device timestamps are
exact, its host side is slowed, so the slice gives shares and counts, and
the unprofiled window the times.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .window import gaps, interval_union

__all__ = ["Slice", "profile", "BUCKETS", "bucket"]

# device operations by the program's and the libraries' kernel names
BUCKETS = (
    ("port kernels", ("pairs_kernel", "s2act_tc_kernel", "so2conv_kernel", "b_operand_kernel",
                      "rot_kernel")),
    ("optimizer (multi-tensor)", ("multi_tensor",)),
    ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv", "splitK")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("reductions", ("reduce_kernel",)),
    ("concat / copy", ("copy", "CatArray", "cat_", "Memcpy", "Memset")),
    ("elementwise", ("elementwise", "Functor")),
)


def bucket(name: str) -> str:
    for label, keys in BUCKETS:
        if any(k in name for k in keys):
            return label
    return "other"


@dataclass
class Slice:
    """A profiled slice: ``units`` steps or requests; device operations
    (name, start s, end s); host operations (name, start s, end s)."""

    units: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def window(self) -> tuple[float, float]:
        ts = [t for _, s, e in self.device + self.host for t in (s, e)]
        return min(ts), max(ts)

    @property
    def window_s(self) -> float:
        s, e = self.window
        return e - s

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in interval_union((s, e) for _, s, e in self.device))

    def kernel_s(self, keys) -> float:
        """Device seconds of the operations whose name holds one of ``keys``."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in keys))

    def idle_gaps(self) -> list[tuple[float, str]]:
        """Every idle gap (seconds, the innermost host operation in flight at
        its start, or "host: no operation"), by one sweep over the host
        operations in start order with a stack of the open ones."""
        union = interval_union((s, e) for _, s, e in self.device)
        lo, hi = self.window
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        out, stack, i = [], [], 0
        for s, e in gaps(union, lo, hi):
            while i < len(host) and host[i][1] <= s:
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] <= s:
                stack.pop()
            label = next((h[0] for h in reversed(stack) if h[2] > s), "host: no operation")
            out.append((e - s, label))
        return out

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for n, s, e in self.device:
            key = f"{bucket(n)}: {n[:120]}"
            by_name[key] = by_name.get(key, 0.0) + (e - s)
        by_gap: dict[str, float] = {}
        for sec, label in self.idle_gaps():
            by_gap[label[:120]] = by_gap.get(label[:120], 0.0) + sec
        return {"device_ops": sorted(([k, v] for k, v in by_name.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in by_gap.items()),
                                    key=lambda kv: -kv[1])[:top]}

    def buckets(self) -> dict:
        out: dict[str, float] = {}
        for n, s, e in self.device:
            out[bucket(n)] = out.get(bucket(n), 0.0) + (e - s)
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile(fn, units: int, sync) -> Slice:
    """Run ``fn()`` (``units`` steps or requests) under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t
    sl = Slice(units, wall_s=wall)
    for ev in prof.events():
        span = (ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
        if ev.device_type == DeviceType.CUDA:
            if not ev.is_user_annotation:
                sl.device.append(span)
        else:
            sl.host.append(span)
    return sl
