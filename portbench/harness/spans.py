"""The program's own spans in a profiled slice: its phases, their share of
the device's idle time, and its host syncs.

The program (``utils/trace.py`` of the port) names its phases and host syncs
with ``torch.profiler.record_function`` while a profiler records, so they
reach ``Slice.host`` on the clock of the device operations.  A phase is a
span whose name starts with one of ``PHASES`` (the loader's wait, the
upload, the request's collate; a training step and its cast, forward,
backward and update; a request, its model and its copies back); the model's
sites (``etq.model.*``) and the syncs (``etq.sync.*``) lie inside phases and
split nothing.  Each idle interval of the slice (no device operation in
flight) is split among the phase spans it overlaps, by the length of the
overlap, each piece to the innermost phase open over it; what no phase
covers is ``OUTSIDE``.  Every reader returns None where the slice holds no
span of the program (a program without spans)."""

from __future__ import annotations

from .trace import Slice
from .window import gaps, interval_union

__all__ = ["PREFIX", "PHASES", "SYNC", "OUTSIDE", "program_spans", "idle_by_phase",
           "idle_ms", "span_ms", "syncs", "sync_wait_ms"]

PREFIX = "etq."
PHASES = ("etq.data.", "etq.step", "etq.request")
SYNC = "etq.sync."
OUTSIDE = "outside the phases"


def program_spans(sl: Slice | None) -> list:
    """The slice's spans of the program: (name, start s, end s)."""
    if sl is None:
        return []
    return [h for h in sl.host if h[0].startswith(PREFIX)]


def _phases(sl: Slice) -> list:
    return [h for h in program_spans(sl) if h[0].startswith(PHASES)]


def idle_by_phase(sl: Slice | None) -> dict | None:
    """Idle seconds of the slice by the innermost phase span over them (and
    ``OUTSIDE``), or None without program spans."""
    if not program_spans(sl):
        return None
    union = interval_union((s, e) for _, s, e in sl.device)
    lo, hi = sl.window
    phases = _phases(sl)
    out: dict = {}
    for gs, ge in gaps(union, lo, hi):
        over = [p for p in phases if p[1] < ge and p[2] > gs]
        cuts = sorted({gs, ge} | {t for _, s, e in over for t in (s, e) if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            open_ = [p for p in over if p[1] <= a and p[2] >= b]
            # the innermost: the latest to start, then the earliest to end
            name = max(open_, key=lambda p: (p[1], -p[2]))[0] if open_ else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_ms(sl: Slice | None, names) -> float | None:
    """Device-idle ms per unit inside the phases ``names`` (innermost)."""
    split = idle_by_phase(sl)
    if split is None:
        return None
    return 1e3 * sum(split.get(n, 0.0) for n in names) / sl.units


def span_ms(sl: Slice | None, name: str) -> float | None:
    """Summed duration of the spans named ``name``, in ms per unit."""
    spans = program_spans(sl)
    if not spans:
        return None
    return 1e3 * sum(e - s for n, s, e in spans if n == name) / sl.units


def _syncs(sl: Slice) -> list:
    return [h for h in program_spans(sl) if h[0].startswith(SYNC)]


def syncs(sl: Slice | None) -> float | None:
    """Sync spans per unit: each counts, nested or not."""
    if not program_spans(sl):
        return None
    return len(_syncs(sl)) / sl.units


def sync_wait_ms(sl: Slice | None) -> float | None:
    """Host ms per unit inside the sync spans, each instant once (a sync
    span inside another is waited for once)."""
    if not program_spans(sl):
        return None
    return 1e3 * sum(e - s for s, e in interval_union((s, e) for _, s, e in _syncs(sl))) / sl.units
