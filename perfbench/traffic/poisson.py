"""Open loop of single-series requests: arrivals of a Poisson process at
``rate_per_s``, drawn from the run's seed before the window, served with
continuous batching of at most ``max_batch`` a step. Every request due in
the window is served, the last ones at most ``DRAIN_S`` past its close;
a request's latency runs from its scheduled arrival to its answer on the
host, so a stall counts against every request that waited behind it.
Request r asks for row r of the query pool, cycling through it."""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.bench.seeds import ARRIVALS, seed_rng

DRAIN_S = 60.0


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Arrival times (s) of the requests due in ``[0, seconds)``."""
    rng = seed_rng(seed, ARRIVALS)
    t = np.cumsum(rng.exponential(1.0 / rate, int(rate * seconds * 1.2) + 64))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate, int(rate * seconds * 0.2) + 64))])
    return t[t < seconds]


def _ring(pool, max_batch: int):
    """The pool with its first rows repeated at its end, so any run of at
    most ``max_batch`` consecutive requests is one slice."""
    return torch.cat([pool, pool[:max_batch]])


def warm(program, pool, wl, seed) -> None:
    """Run the step at the batch sizes the window sees, from 1 up to the
    limit."""
    mb = int(wl["max_batch"])
    for n in sorted({1, 2, 8, 64, mb // 4, mb // 2, mb}):
        program.step(pool[:n])


def drive(program, pool, wl, seconds: float, seed: int) -> dict:
    """Serve the requests due in the window; each step takes every request
    that has arrived, up to the batch limit, in arrival order."""
    mb = int(wl["max_batch"])
    due = arrivals(float(wl["rate_per_s"]), seconds, seed)
    n_req, P = len(due), pool.shape[0]
    ring = _ring(pool, mb)
    done = np.full(n_req, np.nan)
    admitted = np.full(n_req, np.nan)
    step_s, batch, answers = [], [], []
    nxt = 0
    t0 = time.perf_counter()
    while nxt < n_req:
        now = time.perf_counter() - t0
        if now > seconds + DRAIN_S:
            break
        avail = int(np.searchsorted(due, now, side="right"))
        if avail == nxt:
            time.sleep(max(0.0, due[nxt] - now))
            continue
        n = min(avail - nxt, mb)
        lo = nxt % P
        a = program.step(ring[lo:lo + n])
        end = time.perf_counter() - t0
        answers.append(a)
        # a step may answer fewer requests than it was given: the first
        # ones, the rest never
        n_ans = len(next(iter(a.values())))
        admitted[nxt:nxt + n] = now
        done[nxt:nxt + n_ans] = end
        step_s.append(end - now)
        batch.append(n)
        nxt += n
    window_s = time.perf_counter() - t0
    ok = ~np.isnan(done)
    return {"window_s": window_s, "attempted": n_req,
            "answered": int(ok.sum()), "steps": len(step_s),
            "step_s": step_s, "batch": batch,
            "latency_s": (done - due)[ok],
            "admit_lag_s": (admitted - due)[ok], "due_s": due[ok],
            "rows": (np.arange(nxt) % P)[ok[:nxt]],
            "answers": {key: np.concatenate([a[key] for a in answers])
                        for key in answers[0]} if answers else {}}
