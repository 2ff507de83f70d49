"""The benchmark's arithmetic: percentiles, rates and means over every
sample of the window, and the spread the bounds are set from."""
from __future__ import annotations

import statistics

import numpy as np

from perfbench.bench import stats
from perfbench.bench.cells import reader
from perfbench.tests.helpers import ROOT


def _run(loop, **window):
    return {"wl": {"loop": loop, "driver": "knn"}, "window": window,
            "trace": None, "counters": {}, "timings": {}, "setup_s": 1.0}


def test_percentile_is_over_all_samples():
    lat = np.random.default_rng(0).exponential(0.01, 10001)
    want = np.sort(lat)[9500] * 1e3          # exact order statistic
    assert abs(stats.percentile_ms(lat, 95) - want) < 1e-9
    got = reader(ROOT, "request_p95_ms")(_run("poisson", latency_s=lat))
    assert got == stats.percentile_ms(lat, 95)
    # one slow request among many moves the tail only through its rank
    assert stats.percentile_ms(np.r_[np.zeros(99), 5.0], 95) == 0.0


def test_rate_is_over_the_whole_window():
    r = reader(ROOT, "series_per_s")(
        _run("closed", answered=12000, window_s=0.75, step_s=[0.1] * 3))
    assert r == 16000.0
    assert reader(ROOT, "series_per_s")(_run("poisson", answered=1,
                                             window_s=1.0)) is None


def test_step_means_are_over_every_step():
    run = _run("poisson", step_s=[0.001, 0.002, 0.006], batch=[1, 2, 6])
    assert abs(reader(ROOT, "step_ms.online")(run) - 3.0) < 1e-12
    assert reader(ROOT, "batch_fill.online")(run) == 3.0


def test_spread_matches_statistics_quantiles():
    v = [10.0, 10.2, 9.9, 10.4, 10.1, 9.7]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / statistics.median(v)


def test_idle_share_from_the_trace():
    run = _run("closed", answered=4000, window_s=2.0)
    run["trace"] = {"busy_s": 1.5, "window_s": 2.0, "port_s": 1.0,
                    "other_s": 0.25}
    assert reader(ROOT, "device_idle_pct.bulk")(run) == 25.0
    assert reader(ROOT, "kernel_ms.bulk")(run) == 250.0
    assert reader(ROOT, "other_device_ms.bulk")(run) == 62.5
    assert reader(ROOT, "device_idle_pct.online")(run) is None
