"""Closed loop of bulk jobs: one client submits a job of ``job_series``
requests (series, or prompts of a token pool), waits for every answer on
the host, and submits the next, for the whole window. Job k is the k-th
block of ``job_series`` rows of the request pool, cycling through the
pool (``perfbench/bench/pools.py`` says what a pool's rows are)."""
from __future__ import annotations

import time

import numpy as np

from perfbench.bench import pools


def _job(pool, wl, k):
    J = int(wl["job_series"])
    lo = (k % (pools.size(pool) // J)) * J
    return lo, pools.rows(pool, lo, lo + J)


def warm(program, pool, wl, seed) -> None:
    """Run the job shape once, as the window will."""
    program.step(_job(pool, wl, 0)[1])


def drive(program, pool, wl, seconds: float, seed: int) -> dict:
    """Submit jobs until ``seconds`` have passed; the window closes when
    the last job's answers are on the host."""
    t0 = time.perf_counter()
    rows, answers, step_s, batch = [], [], [], []
    k = 0
    while time.perf_counter() - t0 < seconds:
        lo, Q = _job(pool, wl, k)
        s0 = time.perf_counter()
        a = program.step(Q)
        step_s.append(time.perf_counter() - s0)
        answers.append(a)
        # a step may answer fewer series than it was given: the first
        # ones, the rest never
        rows.append(np.arange(lo, lo + len(next(iter(a.values())))))
        batch.append(pools.size(Q))
        k += 1
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "attempted": sum(batch),
            "answered": sum(len(r) for r in rows),
            "steps": k, "step_s": step_s, "batch": batch,
            "rows": np.concatenate(rows),
            "answers": {key: np.concatenate([a[key] for a in answers])
                        for key in answers[0]}}
