"""Shared serving-statistics helpers.

One home for the latency-percentile arithmetic every serving surface
reports: ``launch/search.py`` (per-stage batch latency), the scenario
harness (``launch/scenarios.py``, per-query latency distributions) and
the monitor counters (``repro_torch.monitor``) all format wall-clock
samples through :func:`percentiles`, so the degenerate-stream clamp
exists in one place.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# the percentile grid every latency_ms block reports
PCTS = (50, 95, 99)


def percentiles(samples: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 of a latency sample list (seconds), in milliseconds.

    Degenerate streams clamp instead of propagating NaN into the
    serving artifacts: an empty sample list reports 0.0 at every
    percentile (``np.percentile`` of an empty array is NaN), and a
    single-element list reports that sample everywhere."""
    a = np.asarray(samples, np.float64) * 1e3
    if a.size == 0:
        return {f"p{p}": 0.0 for p in PCTS}
    return {f"p{p}": float(np.percentile(a, p)) for p in PCTS}
