"""Exact statistics of raw samples: percentiles and rates over a
window. No histograms, no EWMAs."""

from __future__ import annotations

import math
from typing import Iterable, Optional


def percentile(values: Iterable[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    the closest ranks, over every sample (numpy's default rule). An
    infinite sample (a failed request) counts as slower than any other."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or xs[hi] == xs[lo]:
        return float(xs[lo])
    if math.isinf(xs[hi]):
        return math.inf
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def highest_percentile_with_tail(n: int, tail: int = 10) -> Optional[int]:
    """The highest whole percentile with at least ``tail`` samples beyond
    it among ``n`` (None below ``tail`` samples)."""
    for q in range(99, 0, -1):
        if n * (100 - q) / 100.0 >= tail:
            return q
    return None


def rate(amount: float, t0: float, t1: float) -> float:
    if t1 <= t0:
        raise ValueError("empty window")
    return amount / (t1 - t0)
