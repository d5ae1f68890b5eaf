"""Percentiles over every request (a failure misses every limit), a rate
as all the work over all the time, and the spread behind a bound."""

import math
import statistics

import numpy as np
import pytest

from zkbench import stats


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_over_all_samples(q):
    xs = list(np.random.default_rng(q).exponential(size=47))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_a_failed_request_counts_as_missing():
    xs = [1.0] * 9 + [math.inf]
    assert stats.percentile(xs, 50) == 1.0
    assert math.isinf(stats.percentile(xs, 95))
    assert math.isinf(stats.percentile([1.0, 2.0] + [math.inf] * 2, 90))


def test_rate_is_all_the_work_over_all_the_time():
    assert stats.rate(72, 48.0) == 1.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)
