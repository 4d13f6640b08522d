"""Named spans of the program's phases and host syncs, on the profiler's clock.

``span(name)`` is ``torch.profiler.record_function(name)`` while a torch
profiler records, and one shared null context otherwise: one check of the
profiler's own flag decides (about 0.5 us a span with no profiler).  The
module keeps no state, no clock and no buffer of its own: the profiler that
records (``utils/profiling.py:profile_call``, the benchmark's traced slice,
or any ``torch.profiler`` an operator runs) stores the spans beside its
device operations and exports them.

``sync(site)`` is ``span("etq.sync." + site)``: every operation of the
training steps and the serving request that blocks the host on the stream
(a blocking upload of a host array, ``.cpu()``, ``.item()`` / ``bool()`` of
a device tensor, an index by a host list) sits inside exactly one such
span, so their number counts the host syncs of a step or request and their
durations time the waits.

``NAMES`` lists every span name but the sync spans' (``SYNC_SITES`` lists
their sites).  The phases: ``etq.data.wait`` (the loader's consumer waits
on the next batch), ``etq.data.h2d`` (``data/graph.py:as_tensors``),
``etq.data.collate`` (``Predictor.collate``); ``etq.step`` (one training
step) with ``etq.step.cast`` (the bf16 copies of the masters),
``etq.step.forward`` (the model and, for MatPES, the force pass),
``etq.step.backward`` (the loss and its backward) and ``etq.step.update``
(guard, clip, AdamW, EMA; inside it ``etq.step.adamw`` and
``etq.step.ema``); ``etq.request`` (``Predictor.predict_batch``) with
``etq.request.model`` and ``etq.request.d2h``.  The model sites, inside the
phases: ``etq.model.wigner``, ``etq.model.embedding``,
``etq.model.attention``, ``etq.model.ffn``, ``etq.model.head`` and
``etq.model.forces``.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

__all__ = ["span", "sync", "NAMES", "SYNC_PREFIX", "SYNC_SITES"]

NAMES = ("etq.data.wait", "etq.data.h2d", "etq.data.collate",
         "etq.step", "etq.step.cast", "etq.step.forward", "etq.step.backward",
         "etq.step.update", "etq.step.adamw", "etq.step.ema",
         "etq.request", "etq.request.model", "etq.request.d2h",
         "etq.model.wigner", "etq.model.embedding", "etq.model.attention",
         "etq.model.ffn", "etq.model.head", "etq.model.forces")
SYNC_PREFIX = "etq.sync."
SYNC_SITES = ("h2d", "guard", "d2h", "wigner_j", "wigner_index", "wigner_consts",
              "rot_consts", "gate_index", "force_index")

_NULL = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` while a torch profiler records; else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


def sync(site: str):
    """The span of one host sync at ``site`` (``etq.sync.<site>``)."""
    return span(SYNC_PREFIX + site)
