"""Streaming drift detection over query sketches.

A fitted corpus fixes a reference distribution in (R,) sketch space:
the rows of the stored (N, R) Random Warping Series sketch matrix. The
``DriftMonitor`` watches the *query* stream in the same coordinates —
each served batch appends its sketch features to a sliding window, and
once the window is full two shift statistics are compared against
thresholds calibrated by seeded permutation under the null:

  * mean shift — the largest per-feature standardized gap between the
    window mean and the corpus mean (scaled by the corpus feature
    std / sqrt(window), the null sampling error of a window mean);
  * quantile shift — the same construction on medians, scaled by the
    corpus feature IQR / sqrt(window), which survives heavy-tailed
    feature noise the mean statistic is blind to.

Calibration draws ``n_perm`` seeded window-sized bootstrap resamples of
the corpus sketch rows (rng keyed from ``spec.seed`` + ``DRIFT_SALT``)
and sets each threshold at the ``1 - alpha`` quantile of its null
distribution — so a trigger means "this window's statistic exceeds all
but an ``alpha`` fraction of same-sized i.i.d. corpus windows".
``update`` is deterministic (no randomness at stream time): the same
seeded stream produces the same trigger step every run. On a trigger
the window is cleared so the next event needs fresh evidence, and the
trigger plugs into ``launch/learner.py``: a ``Learner`` given a
``drift_monitor`` re-learns support occupancy when the monitor fires
instead of (or in addition to) its fixed ``support_every`` cadence.
The port's copy of the reference's module: the same numpy arithmetic
and seeded draws, on sketch features brought to the host.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .embed import host

# rng salt separating drift-null calibration from other seeded draws
DRIFT_SALT = 0xD21F

_EPS = 1e-9


def _shift_stats(W: np.ndarray, mean: np.ndarray, std: np.ndarray,
                 med: np.ndarray, iqr: np.ndarray) -> Dict[str, float]:
    """Window (W, R) -> the two scalar shift statistics against the
    reference moments (max over features of the standardized gaps)."""
    w = W.shape[0]
    root_w = float(np.sqrt(w))
    z_mean = np.abs(W.mean(axis=0) - mean) * root_w / (std + _EPS)
    z_quant = np.abs(np.median(W, axis=0) - med) * root_w / (iqr + _EPS)
    return {"mean_shift": float(z_mean.max()),
            "quantile_shift": float(z_quant.max())}


class DriftMonitor:
    """Streaming two-sample monitor over sliding windows of query
    sketches. Build with :func:`fit_drift_monitor`.

    Mutable streaming state (unlike the frozen engine surfaces): a
    deque window of the last ``window`` query feature rows, the trigger
    history in ``events`` (stream positions, 1-based over series seen),
    and the last computed statistics in ``last_stats``. ``update`` is
    the only state transition; ``reset`` re-arms everything.
    """

    def __init__(self, *, window: int, ref_mean, ref_std, ref_med,
                 ref_iqr, thresholds: Dict[str, float], alpha: float,
                 n_perm: int, seed: int):
        self.window = int(window)
        self.ref_mean = np.asarray(ref_mean, np.float64)
        self.ref_std = np.asarray(ref_std, np.float64)
        self.ref_med = np.asarray(ref_med, np.float64)
        self.ref_iqr = np.asarray(ref_iqr, np.float64)
        self.thresholds = dict(thresholds)
        self.alpha = float(alpha)
        self.n_perm = int(n_perm)
        self.seed = int(seed)
        self._buf: deque = deque(maxlen=self.window)
        self.n_seen = 0
        self.n_windows = 0
        self.events: List[int] = []
        self.last_stats: Optional[Dict[str, float]] = None

    def reset(self) -> None:
        """Clear the window, counters and trigger history (the fitted
        reference moments and thresholds are kept)."""
        self._buf.clear()
        self.n_seen = 0
        self.n_windows = 0
        self.events = []
        self.last_stats = None

    def update(self, feats) -> bool:
        """Feed a batch of query sketch features ((B, R), from
        ``engine.sketch_embed``); returns True iff this batch completed
        a window whose shift statistics breach a calibrated threshold.
        Deterministic — no randomness at stream time. A trigger clears
        the window so consecutive events need disjoint evidence."""
        F = host(feats)
        if F.ndim != 2 or F.shape[1] != self.ref_mean.shape[0]:
            raise ValueError("drift update wants (B, R) sketch features")
        for row in F:
            self._buf.append(row)
        self.n_seen += F.shape[0]
        if len(self._buf) < self.window:
            return False
        W = np.stack(tuple(self._buf))
        st = _shift_stats(W, self.ref_mean, self.ref_std,
                          self.ref_med, self.ref_iqr)
        self.last_stats = st
        self.n_windows += 1
        fired = any(st[name] > self.thresholds[name] for name in st)
        if fired:
            self.events.append(self.n_seen)
            self._buf.clear()
        return fired

    def counters(self) -> Dict[str, object]:
        """Streaming summary for ``SearchEngine.stats()`` / artifacts."""
        return {"n_seen": self.n_seen, "n_windows": self.n_windows,
                "n_events": len(self.events), "events": list(self.events),
                "window": self.window, "alpha": self.alpha,
                "thresholds": dict(self.thresholds),
                "last_stats": dict(self.last_stats)
                if self.last_stats else None}


def fit_drift_monitor(engine, *, window: int = 64, alpha: float = 0.01,
                      n_perm: int = 200) -> DriftMonitor:
    """Calibrate a ``DriftMonitor`` against a fitted engine's corpus
    sketch matrix.

    Reference moments (per-feature mean/std/median/IQR) come from the
    (N, R) corpus sketch; the null distribution of each shift statistic
    comes from ``n_perm`` seeded window-sized bootstrap resamples of
    those same rows (with replacement — the null models the stream as
    i.i.d. *draws from* the corpus distribution, not a subset of the
    corpus, so a without-replacement null would understate the window
    variance by the finite-population correction and over-trigger on
    small corpora), and the thresholds sit at the null's ``1 - alpha``
    quantile. Deterministic under ``MeasureSpec.seed``.
    """
    index = engine.index
    if index is None or index.sketch is None:
        raise ValueError("drift monitoring reads the sketch tier: fit "
                         "with sketch_r > 0")
    S = host(index.sketch.sketch)                          # (N, R)
    N = S.shape[0]
    window = int(window)
    if window < 2:
        raise ValueError("window must hold at least two series")
    ref_mean = S.mean(axis=0)
    ref_std = S.std(axis=0)
    ref_med = np.median(S, axis=0)
    q75, q25 = np.percentile(S, [75, 25], axis=0)
    ref_iqr = q75 - q25
    rng = np.random.default_rng([int(engine.spec.seed), DRIFT_SALT])
    null = {"mean_shift": [], "quantile_shift": []}
    for _ in range(int(n_perm)):
        rows = rng.integers(0, N, size=window)
        st = _shift_stats(S[rows], ref_mean, ref_std, ref_med, ref_iqr)
        for name, v in st.items():
            null[name].append(v)
    thresholds = {name: float(np.quantile(np.asarray(v), 1.0 - alpha))
                  for name, v in null.items()}
    return DriftMonitor(window=window, ref_mean=ref_mean, ref_std=ref_std,
                        ref_med=ref_med, ref_iqr=ref_iqr,
                        thresholds=thresholds, alpha=alpha,
                        n_perm=int(n_perm), seed=int(engine.spec.seed))
