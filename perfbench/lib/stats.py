"""Order statistics and interval arithmetic of the benchmark."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between order statistics
    (numpy's default).  ``inf`` entries sort last: a request that failed or
    never came counts as missing every latency limit."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies(requests: Iterable[dict]) -> List[float]:
    """Seconds from each request's due time (its send time in a closed
    loop) to its last byte; ``inf`` for a request that failed or never
    answered."""
    out = []
    for r in requests:
        if r.get("ok") and r.get("done") is not None:
            out.append(r["done"] - r["due"])
        else:
            out.append(math.inf)
    return out


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median, as ``statistics.quantiles(values, n=4)`` gives them."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union(intervals: Iterable[Tuple[float, float]],
          clip: Optional[Tuple[float, float]] = None) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals,
    each clipped to ``clip``."""
    xs = []
    for a, b in intervals:
        if clip is not None:
            a, b = max(a, clip[0]), min(b, clip[1])
        if b > a:
            xs.append((a, b))
    xs.sort()
    out: List[Tuple[float, float]] = []
    for a, b in xs:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Tuple[float, float]],
            clip: Optional[Tuple[float, float]] = None) -> float:
    """Total length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals, clip))


def gaps(intervals: Sequence[Tuple[float, float]], clip: Tuple[float, float]
         ) -> List[Tuple[float, float]]:
    """The stretches of ``clip`` that no interval of the union covers."""
    out = []
    cursor = clip[0]
    for a, b in union(intervals, clip):
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if clip[1] > cursor:
        out.append((cursor, clip[1]))
    return out
