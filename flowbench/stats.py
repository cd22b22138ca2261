"""The window's arithmetic: rates over the window, a percentile over every
call, and merged busy intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(work: float, window_s: float) -> float:
    """Work completed in the window over the window's length."""
    if window_s <= 0:
        raise ValueError("the window has no length")
    return work / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of every value:
    the smallest value that at least q% of the values do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(math.ceil(q / 100.0 * len(ordered)), 1)
    return ordered[rank - 1]


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Overlapping or touching [start, end) intervals merged, in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The parts of the intervals inside [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of [lo, hi) covered by at least one interval (merged, not summed)."""
    return sum(e - s for s, e in merge(clip(intervals, lo, hi)))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The uncovered stretches of [lo, hi), in order."""
    out, t = [], lo
    for s, e in merge(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
