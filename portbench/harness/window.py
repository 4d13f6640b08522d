"""Arithmetic of a measured window: rates, percentiles, the union of device
intervals and the idle gaps between them."""

from __future__ import annotations

import math

__all__ = ["rate", "percentile", "interval_union", "gaps"]


def rate(units: float, seconds: float) -> float:
    """Work over the whole window's time (a stall counts in the time)."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return units / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of all values, linear between the two closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def interval_union(spans) -> list[tuple[float, float]]:
    """The union of (start, end) spans, as disjoint sorted spans."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(union, start: float, end: float) -> list[tuple[float, float]]:
    """The idle spans of [start, end) outside the disjoint sorted ``union``."""
    out, t = [], start
    for s, e in union:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
