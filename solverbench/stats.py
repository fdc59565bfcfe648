"""The benchmark's arithmetic on samples: a rate over a window, a
percentile of latencies, and the spread of a metric over runs."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("a window of no length has no rate")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of all the values, linear
    between the two nearest order statistics (numpy's default rule)."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, with the quartiles of
    ``statistics.quantiles(values, n=4)``: the spread a bound is set
    from."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
