"""Streaming corpus analytics over the sketch tier: anomaly scoring with
exact-decision escalation, sliding-window drift detection, and a
dataset-scale embedding map.

  anomaly.py   ``AnomalyScorer`` / ``fit_anomaly_scorer`` (K1 calibration
               Gram, K2 clean fast path, the exact cascade for the
               borderline rows), ``roc_auc``
  drift.py     ``DriftMonitor`` / ``fit_drift_monitor`` (numpy)
  embed.py     ``power_iteration_pca`` / ``sketch_map`` (numpy)

The serving-side entry point is :class:`Monitor`: a fitted
:class:`AnomalyScorer` and/or :class:`DriftMonitor` sharing one engine,
with streaming counters. ``SearchEngine(monitor=...)`` calls
:meth:`Monitor.observe` on every served batch (one sketch embedding per
batch, shared by both detectors) and reports the counters and the
monitor's latency stage through ``stats()``. Every seeded draw is the
reference's numpy draw, so decisions and trigger positions equal the
reference's on the same sketch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .anomaly import ANOMALY_SALT, AnomalyScorer, fit_anomaly_scorer, roc_auc
from .drift import DRIFT_SALT, DriftMonitor, fit_drift_monitor
from .embed import EMBED_SALT, power_iteration_pca, sketch_map

__all__ = [
    "ANOMALY_SALT", "AnomalyScorer", "fit_anomaly_scorer", "roc_auc",
    "DRIFT_SALT", "DriftMonitor", "fit_drift_monitor",
    "EMBED_SALT", "power_iteration_pca", "sketch_map",
    "Monitor", "fit_monitor",
]


@dataclasses.dataclass
class Monitor:
    """Serving-side monitor bundle: a fitted engine, optional anomaly /
    drift detectors calibrated on it, and the streaming counters
    ``SearchEngine.stats()`` reports. The detectors stay calibrated on
    *this* engine's corpus: a refreshed serving snapshot keeps being
    scored against it until a new monitor is fitted."""
    engine: object
    anomaly: Optional[AnomalyScorer] = None
    drift: Optional[DriftMonitor] = None
    n_batches: int = 0
    n_scored: int = 0
    n_flagged: int = 0
    n_escalated: int = 0

    def observe(self, Q, *, impl: str = "auto") -> Dict[str, object]:
        """Score one served batch: one sketch embedding feeds both the
        anomaly decision path and the drift window. Returns the per-batch
        outcome (host numpy; the host copies end the card's work for the
        batch, so a caller's clock around it is honest); cumulative
        counts live in ``counters()``."""
        Q = self.engine._series(Q)
        feats = self.engine.sketch_embed(Q, impl=impl)
        out: Dict[str, object] = {"n": int(Q.shape[0])}
        if self.anomaly is not None:
            flags, scores, st = self.anomaly.decide(
                Q, feats=feats, impl=impl, return_stats=True)
            self.n_flagged += int(flags.sum())
            self.n_escalated += int(st["n_escalated"])
            out["flags"] = flags
            out["scores"] = scores
        if self.drift is not None:
            out["drift_fired"] = bool(self.drift.update(feats))
        self.n_batches += 1
        self.n_scored += int(Q.shape[0])
        return out

    def counters(self) -> Dict[str, object]:
        """Cumulative streaming counters for ``SearchEngine.stats()`` and
        the anomaly scenario's payload."""
        out: Dict[str, object] = {
            "n_batches": self.n_batches, "n_scored": self.n_scored}
        if self.anomaly is not None:
            out["n_flagged"] = self.n_flagged
            out["n_escalated"] = self.n_escalated
            out["escalation_rate"] = self.n_escalated / max(self.n_scored, 1)
            out["tau"] = self.anomaly.tau
        if self.drift is not None:
            out["drift"] = self.drift.counters()
        return out

    def reset(self) -> None:
        """Zero the counters and re-arm the drift window (the fitted
        calibration is kept)."""
        self.n_batches = self.n_scored = 0
        self.n_flagged = self.n_escalated = 0
        if self.drift is not None:
            self.drift.reset()


def fit_monitor(engine, *, anomaly: bool = True, drift: bool = True,
                k: int = 3, quantile: float = 0.95, n_cal: int = 64,
                window: int = 64, alpha: float = 0.01, n_perm: int = 200,
                impl: str = "auto") -> Monitor:
    """Calibrate a :class:`Monitor` on a fitted engine, the one-call path
    serving uses. Both detectors are seeded and deterministic; either can
    be switched off. Needs an engine fit with ``sketch_r > 0``."""
    if not (anomaly or drift):
        raise ValueError("fit_monitor with both detectors off")
    scorer = fit_anomaly_scorer(engine, k=k, quantile=quantile,
                                n_cal=n_cal, impl=impl) if anomaly else None
    dm = fit_drift_monitor(engine, window=window, alpha=alpha,
                           n_perm=n_perm) if drift else None
    return Monitor(engine=engine, anomaly=scorer, drift=dm)
