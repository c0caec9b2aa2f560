"""Tails and rates as the benchmark defines them."""
from __future__ import annotations

import math
from typing import Optional, Sequence


def pct(values: Sequence[float], p: float) -> Optional[float]:
    """The nearest-rank `p`-th percentile (0 < p <= 100) of every value: the
    smallest value with at least p% of the values at or below it.  A value
    of `math.inf` stands for a request that failed or never finished, so a
    tail that reaches one is infinite.  None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    k = max(1, math.ceil(p / 100.0 * len(xs)))
    return float(xs[k - 1])


def rate(events: Sequence[float], t0: float, t1: float) -> float:
    """Events per second whose time falls in [t0, t1), over the whole
    interval: a stall anywhere in it lowers the rate."""
    return sum(1 for t in events if t0 <= t < t1) / (t1 - t0)


def mean(values: Sequence[float]) -> Optional[float]:
    return float(sum(values) / len(values)) if values else None
