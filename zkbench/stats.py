"""The metric arithmetic: percentiles over every request, rates over all
the work and all the time, and the spread that sets a bound."""

from __future__ import annotations

import math
import statistics


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default). A failed request enters as +inf, so it
    misses every limit; the result is inf when the rank lands on one."""
    if not values:
        raise ValueError("no samples")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]) and pos > lo or math.isinf(xs[lo]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return count / seconds


def spread(values: list[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def median(values: list[float]) -> float:
    return statistics.median(values)
