"""Exact percentiles and rates on known samples."""

import math

import pytest

from perfbench import stats


def test_percentiles_are_exact_on_known_samples():
    xs = list(range(1, 101))                     # 1..100
    assert stats.percentile(xs, 50) == pytest.approx(50.5)
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, math.inf], 50) == 2.5
    assert math.isinf(stats.percentile([1, 2, math.inf, math.inf], 95))


def test_highest_percentile_with_ten_samples_beyond_it():
    assert stats.highest_percentile_with_tail(200) == 95
    assert stats.highest_percentile_with_tail(1000) == 99
    assert stats.highest_percentile_with_tail(100) == 90
    assert stats.highest_percentile_with_tail(9) is None


def test_window_rates():
    assert stats.rate(300, 10.0, 40.0) == pytest.approx(10.0)
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)
