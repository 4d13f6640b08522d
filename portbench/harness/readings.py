"""What a run hands the per-layer metric readers (``metrics/<name>.py``)."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

from .trace import Slice

__all__ = ["Readings"]


@dataclass
class Readings:
    """The window's host-clock records and the profiled slice of one run.

    ``model`` and ``outputs``: the configuration's model keys and outputs;
    ``mode``: "train" or "serve"; ``compute``: the compute type;
    ``window_s``: the unprofiled window; ``unit_shapes``: (n_pad, e_pad,
    n_real, e_real) of each step or request of the window;
    ``slice_shapes``: the same of the profiled slice's units; ``counts``:
    the module of ``counts/`` that counts the configuration's work (its
    ``counts`` key; ``ops`` by default)."""

    model: dict
    outputs: dict
    mode: str
    compute: str
    window_s: float
    unit_shapes: list
    loader_wait_s: list = field(default_factory=list)
    collate_s: list = field(default_factory=list)
    service_s: list = field(default_factory=list)
    slice: Slice | None = None
    slice_shapes: list = field(default_factory=list)
    counts: str = "ops"

    @property
    def ops(self):
        return importlib.import_module(f"portbench.counts.{self.counts}")

    def bound_s(self, which: str) -> float:
        """Least seconds of the slice's ``"rotation"`` or ``"s2act"`` work."""
        ops = self.ops
        fn = ops.rotation_ops if which == "rotation" else ops.s2act_ops
        return sum(ops.bound_seconds(fn(self.model, self.outputs, self.mode, self.compute,
                                        n_pad, e_pad))
                   for n_pad, e_pad, _, _ in self.slice_shapes)

    def roofline(self, which: str, keys) -> float | None:
        """Percent of the bound that the slice's kernels named by ``keys``
        reach (None when no such kernel ran)."""
        if self.slice is None:
            return None
        t = self.slice.kernel_s(keys)
        if t <= 0:
            return None
        return 100.0 * self.bound_s(which) / t

    def mfu(self, seconds: float) -> float | None:
        """Percent of the compute type's peak: the window's model FLOPs over
        ``seconds``."""
        if seconds <= 0 or not self.unit_shapes:
            return None
        ops = self.ops
        flops = sum(ops.model_flops(self.model, self.outputs, self.mode, n, e)
                    for _, _, n, e in self.unit_shapes)
        return 100.0 * flops / seconds / ops.MFU_PEAK[self.compute]

    def idle(self) -> float | None:
        if self.slice is None or not self.slice.device:
            return None
        return 100.0 * (1.0 - self.slice.busy_s / self.slice.window_s)

    def launches(self) -> float | None:
        if self.slice is None or not self.slice.device:
            return None
        return len(self.slice.device) / self.slice.units
