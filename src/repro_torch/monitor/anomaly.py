"""Sketch-space anomaly scoring with exact-decision escalation.

The Random Warping Series sketch index makes every fitted corpus an
(N, R) coordinate system; this module reads it as a monitoring surface:
the *score* of an arriving series is its k-NN distance to the corpus in
(R,) sketch space (two matmuls per batch after the R embedding DPs), and
the *decision* (flagged or clean at a threshold calibrated on seeded
corpus score quantiles) is made in exact-distance space, so it equals
scoring every query with the exact cascade:

  * clean fast path: one exact DP (K2 on the card) against the
    sketch-nearest candidate gives an upper bound ``d_ub >= d_nn``;
    ``d_ub <= tau`` proves the query has a corpus neighbour within the
    threshold;
  * flag fast path: the admissible lower bounds (banded LB_Kim and
    support-windowed LB_Keogh, both orientations) give per-candidate
    floors; when even the smallest floor exceeds ``tau``, every
    candidate is farther than the threshold;
  * escalation: the queries neither path certifies (the borderline band
    around ``tau``) run the full exact cascade (``engine.knn``). The
    port runs only those rows; the reference pads them to the batch's
    shape for its compiler's cache, which changes no decision.

``tau`` is the ``quantile`` of exact leave-one-out 1-NN distances over a
seeded calibration subset of the corpus (K1 on the card), so a fitted
scorer is reproducible from ``(engine, config)`` alone. The seeded draws
are numpy, the reference's, so both packages calibrate on the same rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .embed import host

# rng salt separating anomaly calibration from other seeded draws
# (the sketch anchors use core.sketch.ANCHOR_SALT)
ANOMALY_SALT = 0xA70C


def roc_auc(scores, labels) -> float:
    """Rank (Mann-Whitney) ROC-AUC of ``scores`` against binary
    ``labels`` (1 = positive/outlier). Tie-averaged ranks, numpy only."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels).astype(bool)
    n1 = int(y.sum())
    n0 = len(y) - n1
    if n1 == 0 or n0 == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s), np.float64)
    i = 0
    sv = s[order]
    while i < len(s):
        j = i
        while j < len(s) and sv[j] == sv[i]:
            j += 1
        ranks[order[i:j]] = 0.5 * (i + j - 1) + 1.0   # average tied ranks
        i = j
    return float((ranks[y].sum() - n1 * (n1 + 1) / 2.0) / (n0 * n1))


def _sketch_knn_scores(feats: np.ndarray, sketch: np.ndarray,
                       sq: np.ndarray, k: int,
                       exclude: Optional[np.ndarray] = None) -> np.ndarray:
    """(B, R) query feats -> (B,) mean squared sketch distance to the k
    nearest corpus rows, in float64 on the host. ``exclude`` masks one
    corpus id per query (leave-one-out calibration)."""
    feats = host(feats)
    S = host(sketch)
    d2 = (feats * feats).sum(1)[:, None] + host(sq)[None] \
        - 2.0 * (feats @ S.T)                                    # (B, N)
    d2 = np.maximum(d2, 0.0)
    if exclude is not None:
        d2[np.arange(len(feats)), np.asarray(exclude)] = np.inf
    k = int(min(k, d2.shape[1] - (1 if exclude is not None else 0)))
    k = max(k, 1)
    part = np.partition(d2, k - 1, axis=1)[:, :k]
    return part.mean(axis=1)


@dataclasses.dataclass(frozen=True)
class AnomalyScorer:
    """A fitted sketch-space anomaly scorer.

    engine:      the fitted ``SimilarityEngine`` (with a sketch index, i.e.
                 fit with ``sketch_r > 0``) the scorer reads sketches,
                 bounds and the exact cascade from;
    k:           sketch-space neighbours averaged into the score;
    quantile:    calibration quantile of the exact LOO 1-NN distances
                 that sets ``tau``;
    tau:         the exact-distance decision threshold: a query is
                 flagged iff its exact 1-NN distance exceeds ``tau``;
    cal_dists:   exact LOO 1-NN distances of the seeded calibration rows
                 (sorted);
    cal_scores:  sketch k-NN scores of every corpus row under
                 leave-one-out (sorted; what ``calibrated`` normalises
                 against).

    ``decide`` is the serving entry point; ``decide_exact`` the
    brute-force oracle it must equal.
    """
    engine: object
    k: int
    quantile: float
    tau: float
    cal_dists: np.ndarray
    cal_scores: np.ndarray

    # ---- scoring ----------------------------------------------------------
    def score(self, Q=None, *, feats=None, impl: str = "auto") -> np.ndarray:
        """Sketch-space k-NN score of each query: (B, T) -> (B,). Pass
        precomputed ``feats`` ((B, R), from ``engine.sketch_embed``) to
        skip the embedding DPs."""
        si = self.engine.index.sketch
        if feats is None:
            if Q is None:
                raise ValueError("score needs Q or precomputed feats")
            feats = self.engine.sketch_embed(Q, impl=impl)
        return _sketch_knn_scores(feats, si.sketch, si.sq, self.k)

    def calibrated(self, scores) -> np.ndarray:
        """Empirical corpus quantile of raw sketch scores: the fraction
        of leave-one-out corpus scores at or below each value, a
        scale-free [0, 1] severity."""
        pos = np.searchsorted(self.cal_scores, np.asarray(scores),
                              side="right")
        return pos / max(len(self.cal_scores), 1)

    # ---- decisions --------------------------------------------------------
    def decide(self, Q, *, feats=None, impl: str = "auto",
               return_stats: bool = False):
        """Flag/clean decision per query, equal to ``decide_exact`` by
        construction.

        Returns ``(flags, scores[, stats])``: flags is (B,) bool (True =
        anomalous, exact 1-NN distance > ``tau``), scores the raw sketch
        k-NN statistic, both host numpy. Stats count the fast-path
        certificates and the escalations (the borderline rows that paid
        a full cascade)."""
        from repro_torch.core import bounds as _bounds
        from repro_torch.core.sketch import sketch_shortlist
        from repro_torch.kernels import backends as bk
        from repro_torch.kernels.ops import _pair_dp
        eng = self.engine
        index = eng.index
        si = index.sketch
        Q = eng._series(Q)
        if feats is None:
            feats = eng.sketch_embed(Q, impl=impl)
        feats = torch.as_tensor(feats, dtype=torch.float32,
                                device=Q.device)
        B = int(Q.shape[0])
        scores = _sketch_knn_scores(feats, si.sketch, si.sq, self.k)
        tau = np.float32(self.tau)
        impl_r = bk.resolve(impl, device=Q.device,
                            require=(bk.EARLY_ABANDON, bk.PRUNED_DP)).name

        # clean fast path: the exact DP to the sketch-nearest candidate is
        # an upper bound on the true 1-NN distance
        cand, _ = sketch_shortlist(feats, si, 1)
        d_ub = _pair_dp(Q, index.corpus[cand[:, 0].long()], index, impl_r)
        clean = (d_ub <= float(tau)).cpu().numpy()

        # flag fast path: the min over candidates of the admissible lower
        # bounds above tau certifies every candidate farther than tau
        lb = _bounds.lb_kim_band_cross(Q, index.corpus, index.lo, index.hi,
                                       index.wmin_rows, index.w00,
                                       index.wTT)
        lb = torch.maximum(lb, _bounds.lb_keogh_cross(
            Q, index.env_lo, index.env_hi, index.wmin_rows))
        q_lo, q_hi = _bounds.envelopes(Q, index.lo_t, index.hi_t)
        lb = torch.maximum(lb, _bounds.lb_keogh_cross(
            index.corpus, q_lo, q_hi, index.wmin_cols).T)
        certified = (torch.amin(lb, dim=1) > float(tau)).cpu().numpy()

        flags = certified.copy()
        borderline = ~clean & ~certified
        n_esc = int(borderline.sum())
        if n_esc:
            # escalation: the exact cascade decides the borderline rows
            rows = torch.as_tensor(np.nonzero(borderline)[0],
                                   device=Q.device)
            _, d_exact = eng.knn(Q[rows], impl=impl)
            flags[borderline] = d_exact.cpu().numpy() > tau
        if not return_stats:
            return flags, scores
        stats = {"n_queries": B, "n_flagged": int(flags.sum()),
                 "n_clean_fast": int((clean & ~borderline).sum()),
                 "n_flag_fast": int((certified & ~borderline).sum()),
                 "n_escalated": n_esc,
                 "escalation_rate": n_esc / max(B, 1)}
        return flags, scores, stats

    def decide_exact(self, Q, *, impl: str = "auto"
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """The oracle: exact cascade 1-NN distance per query, flagged iff
        it exceeds ``tau``. Returns (flags, exact_nn_dist) as host numpy:
        what ``decide`` must equal bit for bit."""
        _, d = self.engine.knn(Q, impl=impl)
        d = d.cpu().numpy()
        return d > np.float32(self.tau), d


def fit_anomaly_scorer(engine, *, k: int = 3, quantile: float = 0.95,
                       n_cal: int = 64, impl: str = "auto"
                       ) -> AnomalyScorer:
    """Calibrate an ``AnomalyScorer`` on a fitted engine's corpus.

    A seeded subset of ``n_cal`` corpus rows (numpy rng keyed from
    ``spec.seed`` and ``ANOMALY_SALT``, the reference's draw) gets exact
    leave-one-out 1-NN distances through the Gram engine (K1 on the
    card); ``tau`` is their ``quantile``. Sketch k-NN scores of every
    corpus row under leave-one-out (matmuls on the stored (N, R) sketch)
    form the reference distribution of ``calibrated``. Deterministic:
    same engine and config, same scorer.
    """
    index = engine.index
    if index is None or index.sketch is None:
        raise ValueError("anomaly scoring reads the sketch tier: fit with "
                         "sketch_r > 0")
    si = index.sketch
    N = si.size
    if N < 2:
        raise ValueError("calibration needs at least two corpus series")
    rng = np.random.default_rng([int(engine.spec.seed), ANOMALY_SALT])
    n_cal = int(min(max(n_cal, 2), N))
    rows = np.sort(rng.permutation(N)[:n_cal])
    sel = torch.as_tensor(rows, device=index.corpus.device)
    D = host(engine.gram(index.corpus[sel], impl=impl))         # (n_cal, N)
    D[np.arange(n_cal), rows] = np.inf
    cal_dists = np.sort(D.min(axis=1))
    tau = float(np.quantile(cal_dists, float(quantile)))
    S = host(si.sketch)
    cal_scores = np.sort(_sketch_knn_scores(
        S, S, si.sq, k, exclude=np.arange(N)))
    return AnomalyScorer(engine=engine, k=int(k), quantile=float(quantile),
                         tau=tau, cal_dists=cal_dists,
                         cal_scores=cal_scores)
