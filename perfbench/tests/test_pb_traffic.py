"""The traffic generator: schedules and per-request inputs repeat from a
seed, and every seed offers the same work in another order."""

import numpy as np
import pytest

from perfbench.lib import traffic


def test_poisson_schedule_repeats_from_its_seed():
    a = traffic.poisson_offsets(7.0, 40.0, 11, 12345678901)
    b = traffic.poisson_offsets(7.0, 40.0, 11, 12345678901)
    assert a == b
    assert a != traffic.poisson_offsets(7.0, 40.0, 11, 12345678902)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**40])
def test_poisson_schedule_same_work_every_seed(seed):
    base = traffic.poisson_offsets(7.0, 40.0, 11, 3)
    mine = traffic.poisson_offsets(7.0, 40.0, 11, seed)
    assert len(mine) == len(base) == 280
    assert mine[0] == 0.0 and all(0 <= o < 40.0 for o in mine)
    assert all(b > a for a, b in zip(mine, mine[1:]))
    # the same multiset of gaps, in another order
    gaps = lambda xs: sorted(np.round(np.diff(xs + [40.0]), 9))  # noqa: E731
    assert gaps(mine)[:-1] == pytest.approx(gaps(base)[:-1], abs=1e-6)


def test_poisson_gaps_are_exponential():
    gaps = np.diff(traffic.poisson_offsets(50.0, 400.0, 5, 9))
    assert np.mean(gaps) == pytest.approx(1 / 50.0, rel=0.02)
    assert np.std(gaps) == pytest.approx(1 / 50.0, rel=0.1)  # exponential: std = mean


def test_request_seeds_distinct_and_repeat():
    s = traffic.request_seeds(2**35 + 3, 500)
    assert s == traffic.request_seeds(2**35 + 3, 500)
    assert len(set(s)) == 500 and all(1 <= x < 2**31 for x in s)


def test_cycle_and_sample():
    out = traffic.cycle_permuted(list("abc"), 7, 4)
    assert sorted(out[:3]) == list("abc") and sorted(out[3:6]) == list("abc")
    assert traffic.sample_indices(3, 10, 4) == traffic.sample_indices(3, 10, 4)
    assert traffic.sample_indices(3, 3, 4) == [0, 1, 2]


def test_photo_like_repeats_and_varies():
    a = traffic.photo_like(40, 24, 5)
    assert a.shape == (24, 40, 3) and a.dtype == np.uint8
    assert np.array_equal(a, traffic.photo_like(40, 24, 5))
    assert a.std() > 10
