"""The benchmark's arithmetic over samples: percentiles and rates over
every sample taken, and the spread the bounds are set from."""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile_ms(samples_s: Sequence[float], p: float) -> float:
    """The ``p``-th percentile of latencies given in seconds, in ms, over
    all of them (linear interpolation between order statistics, as the
    port's ``launch/stats.percentiles``); NaN when there are none."""
    a = np.asarray(samples_s, np.float64) * 1e3
    return float(np.percentile(a, p)) if a.size else float("nan")


def rate(count: float, seconds: float) -> float:
    """Work completed per second of the whole window."""
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
