"""Metric arithmetic: rates over completed requests, percentiles with
their sample counts, spreads, and the union of device intervals."""
from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100), nearest rank: the smallest value with
    at least q% of the sample at or below it."""
    if not values:
        return None
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[k - 1])


def rate(amounts: Iterable[float], t_start: float, t_end: float
         ) -> Optional[float]:
    """Sum of ``amounts`` over the time from ``t_start`` to ``t_end``."""
    span = t_end - t_start
    total = float(sum(amounts))
    return total / span if span > 0 and total > 0 else None


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float = -math.inf, hi: float = math.inf) -> float:
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def spread(values: Sequence[float]) -> float:
    """(Q3 - Q1) / median, with Python's default quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else math.inf
