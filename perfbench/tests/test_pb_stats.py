"""Percentiles over every request due, failures as misses; the interval
union behind the idle share; the quartile spread."""

import math
import statistics

import numpy as np
import pytest

from perfbench.lib import stats


def test_percentile_matches_numpy():
    xs = list(np.random.default_rng(0).exponential(1.0, 333))
    for q in (50, 90, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_failures_count_as_misses():
    reqs = [{"due": 0.0, "done": 1.0, "ok": True}] * 95 + [{"due": 0.0, "done": None, "ok": False}] * 5
    lat = stats.latencies(reqs)
    assert lat.count(math.inf) == 5
    assert stats.percentile(lat, 95) == math.inf  # 5 % missing reaches the 95th percentile
    assert stats.percentile(lat, 90) == 1.0
    # a late answer is late, not missing: it counts from its due time
    late = [{"due": 2.0, "sent": 2.5, "done": 5.0, "ok": True}]
    assert stats.latencies(late) == [3.0]


def test_union_and_gaps():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert stats.union(ivs) == [(0, 3), (5, 6), (9, 12)]
    assert stats.covered(ivs, (1, 10)) == pytest.approx(2 + 1 + 1)
    assert stats.gaps(ivs, (1, 10)) == [(3, 5), (6, 9)]
    # two streams overlapping: busy is the union, not the sum
    assert stats.covered([(0, 4), (1, 3)], (0, 10)) == 4


def test_spread_is_iqr_over_median():
    xs = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)
