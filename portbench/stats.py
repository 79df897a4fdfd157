"""The arithmetic of the metrics: percentiles over every request, rates
over the whole window, interval unions for busy and idle time."""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence


def percentile(values: Sequence[Optional[float]], q: float) -> float:
    """Nearest-rank q-th percentile (0 < q <= 100) over every value; a
    missing value (None: a dropped or failed request) ranks above all
    others, so it reads as inf where it lands on the rank."""
    if not values:
        raise ValueError("no values")
    ranked = sorted(math.inf if v is None else float(v) for v in values)
    return ranked[max(math.ceil(q / 100.0 * len(ranked)), 1) - 1]


def median(values: Sequence[float]) -> float:
    ranked = sorted(values)
    n = len(ranked)
    return ranked[n // 2] if n % 2 else 0.5 * (ranked[n // 2 - 1] + ranked[n // 2])


def rate(done: int, window_s: float) -> float:
    """Work completed in the window over the window's whole length."""
    if window_s <= 0:
        raise ValueError("empty window")
    return done / window_s


def union(intervals: Iterable[tuple]) -> list[tuple]:
    """Sorted disjoint (start, end) intervals covering the same points."""
    out: list[list] = []
    for s, e in sorted((float(s), float(e)) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals: Iterable[tuple]) -> float:
    return sum(e - s for s, e in union(intervals))


def intersect(a: Iterable[tuple], b: Iterable[tuple]) -> list[tuple]:
    """The union of a intersected with the union of b."""
    ua, ub = union(a), union(b)
    out, j = [], 0
    for s, e in ua:
        while j < len(ub) and ub[j][1] <= s:
            j += 1
        k = j
        while k < len(ub) and ub[k][0] < e:
            lo, hi = max(s, ub[k][0]), min(e, ub[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def idle_share(spans: Iterable[tuple], busy: Iterable[tuple]) -> Optional[float]:
    """Percent of the union of `spans` in which nothing in `busy` runs;
    None when the spans cover no time."""
    spans = union(spans)
    total = length(spans)
    if total <= 0:
        return None
    return 100.0 * (1.0 - length(intersect(spans, busy)) / total)


def gaps(busy: Iterable[tuple], start: float, end: float) -> list[tuple]:
    """The intervals of [start, end] that `busy` leaves uncovered."""
    out, t = [], start
    for s, e in union(busy):
        if e <= start or s >= end:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return out
