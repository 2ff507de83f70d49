"""The TwoPatterns series of the benchmark, made from the run's seed.

A frozen copy of the port's ``data/synthetic_ucr.make_two_patterns``
(up / down step pairs at random positions, 4 classes UU, UD, DU, DD,
each series z-normalised as the UCR archive stores it), so the series a
cell runs on cannot change under a later change of the program. The
UCR archive's own TwoPatterns files are not in the repository; each
configuration says so under ``assumed``.

The data source of every configuration that names none (``"data"``):
``cell_data`` makes the host arrays, ``on_device`` what the program is
set up with and the pool its requests are cut from.
"""
from __future__ import annotations

import numpy as np
import torch

# the seed's streams, kept importable from here for the callers that drew
# them from this module
from perfbench.bench.seeds import (ARRIVALS, POOL, SAMPLE, TRAIN,  # noqa: F401
                                   seed_rng)


def _znorm(X: np.ndarray) -> np.ndarray:
    mu = X.mean(axis=1, keepdims=True)
    sd = X.std(axis=1, keepdims=True) + 1e-8
    return ((X - mu) / sd).astype(np.float32)


def two_patterns(n: int, T: int, rng: np.random.Generator):
    """``n`` TwoPatterns series of length ``T`` and their labels, in the
    generator's own order: (X (n, T) float32 z-normalised, y (n,) int32)."""
    X = rng.normal(scale=0.3, size=(n, T))
    y = rng.integers(0, 4, size=n)
    for i in range(n):
        p1 = rng.integers(T // 16, T // 2 - T // 8)
        p2 = rng.integers(T // 2, T - T // 8)
        w = T // 12
        s1 = 1.0 if y[i] in (0, 1) else -1.0   # first pattern up / down
        s2 = 1.0 if y[i] in (0, 2) else -1.0   # second pattern up / down
        X[i, p1:p1 + w] += 5.0 * s1
        X[i, p2:p2 + w] += 5.0 * s2
    order = rng.permutation(n)
    return _znorm(X[order]), y[order].astype(np.int32)


def cell_data(cfg: dict, pool: int, seed: int) -> dict:
    """The train split of configuration ``cfg``, one fixed draw (its
    ``train_seed``) as a deployment's split is fixed, and a query pool of
    ``pool`` series of the same distribution made from the run's
    ``seed``: {"X_train", "y_train", "pool", "y_pool"} as numpy arrays.
    The split fixes the learnt support, and so the work of every step:
    runs of other seeds send other queries to the same model."""
    n_train, T = int(cfg["n_train"]), int(cfg["T"])
    X, y = two_patterns(n_train, T, seed_rng(cfg["train_seed"], TRAIN))
    P, yp = two_patterns(pool, T, seed_rng(seed, POOL))
    return {"X_train": X, "y_train": y, "pool": P, "y_pool": yp}


def on_device(data: dict, device) -> tuple:
    """(the arguments of ``Program.setup``, the request pool) on
    ``device``: the train split's series and labels, and the pool's
    series as one float32 tensor."""
    X = torch.as_tensor(data["X_train"], device=device)
    pool = torch.as_tensor(data["pool"], device=device)
    return (X, data["y_train"]), pool
