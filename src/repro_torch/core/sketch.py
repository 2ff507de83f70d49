"""Random Warping Series sketch tier: sub-linear retrieval.

The counterpart of ``repro.core.sketch``. The distance of a series to a
handful of short random warping anchors is a feature map whose geometry
tracks the alignment measure, so retrieval runs as one matmul over
sketches plus a constant number of exact DPs:

  * ``random_anchors`` draws R anchors from an explicit CPU
    ``torch.Generator`` (``anchor_generator`` seeds it from the spec's
    seed and ``ANCHOR_SALT``): an intrinsic length D ~ U[min_len,
    max_len], a Gaussian random walk of D points, resampled to the corpus
    length T (``interp``, ``jnp.interp``'s twin) and z-normalized. The
    draws are made on the CPU, so every device gets the same anchors;
    they are not the reference's (jax's threefry draws have no torch
    twin), and ``convert`` carries a reference engine's anchors across;
  * ``sketch_embed`` maps series to their SP-DTW distances to the
    anchors through the engine's Gram bodies: K1 on the card, K7 for the
    soft embedding (``gamma`` set);
  * ``build_sketch_index`` freezes the (N, R) corpus sketch as a
    ``SketchIndex``, carried on the ``CorpusIndex`` built by ``fit``;
  * ``sketch_knn`` embeds the queries, scores all N candidates with one
    FP32 matmul (``sketch_shortlist``), keeps the top-C, then re-ranks
    them exactly: a K2 seed DP on the sketch-nearest candidate, LB_Kim
    and both LB_Keogh orientations on the gathered shortlist, and the
    survivors through K2 with thresholds. The answer equals the exact
    cascade's whenever the shortlist holds the true neighbour;
    ``approx=True`` stops after the seed DP.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .dtw import INF

# salt separating anchor generation from other spec-seeded draws
ANCHOR_SALT = 0x5E7C
# the re-rank's gathered bounds are built this many (query, candidate,
# time) elements at a time
_RERANK_CHUNK = 1 << 24


# ---------------------------------------------------------------------------
# Anchor generation (deterministically seeded, on the CPU)
# ---------------------------------------------------------------------------

def anchor_generator(seed: int) -> torch.Generator:
    """The CPU generator the anchors of a spec with ``seed`` are drawn
    from, seeded from the seed and ``ANCHOR_SALT``."""
    g = torch.Generator(device="cpu")
    g.manual_seed((int(seed) * 0x10000 + ANCHOR_SALT) % (1 << 64))
    return g


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: piecewise-linear interpolation on the
    increasing knots ``xp`` (at least two), constant past either end.
    Kept to ``jnp.interp``'s arithmetic: the interval comes from a
    right-sided search (so x == xp[-1] interpolates on the last
    interval), and a zero-width interval (equal knots) yields its left
    value."""
    L = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, L - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    e = torch.tensor(torch.finfo(xp.dtype).eps, dtype=xp.dtype)
    dx0 = dx.abs() <= torch.nextafter(e, 2 * e) - e     # np.spacing(eps)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(
                        dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def random_anchors(key: torch.Generator, R: int, T: int, *, d: int = 1,
                   min_len: int = 4, max_len: Optional[int] = None,
                   sigma: float = 1.0) -> torch.Tensor:
    """Draw R random warping anchor series of length T from the CPU
    generator ``key``.

    Each anchor is a *short* random series: an intrinsic length
    D ~ U[min_len, max_len] (default max_len = max(min_len + 1, T // 4)),
    a Gaussian random walk of D steps scaled by ``sigma``, linearly
    resampled to T points (so the learned (T, T) support applies) and
    z-normalized like the corpus. Returns (R, T) float32 on the CPU, or
    (R, T, d) when d > 1. Generators in the same state give the same
    anchors.
    """
    if R <= 0 or T <= 1:
        raise ValueError("random_anchors needs R > 0 and T > 1")
    if max_len is None:
        max_len = max(min_len + 1, T // 4)
    max_len = int(min(max_len, T))
    min_len = int(min(min_len, max_len))
    lens = torch.randint(min_len, max_len + 1, (R,), generator=key)
    steps = torch.randn((R, max_len, d), generator=key) * sigma
    walk = torch.cumsum(steps, dim=1)                            # (R, L, d)
    # resample walk[r, :lens[r]] to T points: positions in [0, D - 1]
    pos = torch.linspace(0.0, 1.0, T)[None, :] * \
        (lens[:, None] - 1).to(torch.float32)                    # (R, T)
    grid = torch.arange(max_len, dtype=torch.float32)
    A = torch.stack([torch.stack([interp(pos[r], grid, walk[r, :, k])
                                  for k in range(d)], dim=1)
                     for r in range(R)])                         # (R, T, d)
    mu = A.mean(dim=1, keepdim=True)
    sd = A.std(dim=1, keepdim=True, unbiased=False)
    A = ((A - mu) / (sd + 1e-8)).to(torch.float32)
    return A[:, :, 0] if d == 1 else A


# ---------------------------------------------------------------------------
# Embedding through the engine's Gram bodies
# ---------------------------------------------------------------------------

def sketch_embed(X, anchors, *, sp=None, bsp=None, weights=None,
                 gamma: Optional[float] = None, impl: str = "auto",
                 block_a: int = 64) -> torch.Tensor:
    """(N, T[, d]) series -> (N, R) SP-DTW distances to the anchors, on
    the device of ``X``: K1 on the card, the plain tile scan on the CPU.
    ``gamma`` switches to the soft-SP-DTW embedding (K7 on the card)."""
    from repro_torch.kernels import backends as bk
    from repro_torch.kernels import ops
    from repro_torch.kernels.soft_block import soft_spdtw_gram_batch
    X = X.to(torch.float32)
    anchors = torch.as_tensor(anchors).to(device=X.device,
                                          dtype=torch.float32)
    if gamma is not None:
        w = bk.resolve_dense_weights(sp, bsp, weights, T=X.shape[1],
                                     device=X.device)
        with torch.no_grad():
            return soft_spdtw_gram_batch(X, anchors, w, float(gamma),
                                         bsp=bsp)
    return ops._spdtw_gram(X, anchors, sp=sp, bsp=bsp, weights=weights,
                           impl=impl, block_a=block_a)


@dataclasses.dataclass(frozen=True)
class SketchIndex:
    """The (N, R) Random-Warping-Series sketch of a fitted corpus.

    anchors:  (R, T[, d]) random warping anchor series (drawn from the
              spec's seed), on the index device;
    sketch:   (N, R) float32 corpus embedding, series n's SP-DTW
              distance to each anchor on the learned support;
    sq:       (N,) squared norms ``||sketch_n||^2`` (the candidate-side
              term of the shortlist score);
    seed:     the integer seed the anchors were drawn from;
    gamma:    soft-embedding temperature (None = hard SP-DTW).
    """
    anchors: torch.Tensor
    sketch: torch.Tensor
    sq: torch.Tensor
    seed: int = 0
    gamma: Optional[float] = None

    @property
    def R(self) -> int:
        """Number of anchors (the sketch width)."""
        return int(self.anchors.shape[0])

    @property
    def size(self) -> int:
        """Number of sketched corpus series."""
        return int(self.sketch.shape[0])


def build_sketch_index(corpus, anchors, *, sp=None, bsp=None, weights=None,
                       gamma: Optional[float] = None, impl: str = "auto",
                       seed: int = 0, block_a: int = 64) -> SketchIndex:
    """Embed a corpus against ``anchors`` (one N x R Gram) and freeze the
    result, on the corpus's device."""
    feats = sketch_embed(corpus, anchors, sp=sp, bsp=bsp, weights=weights,
                         gamma=gamma, impl=impl, block_a=block_a)
    feats = torch.clamp_max(feats, INF)
    return SketchIndex(
        anchors=torch.as_tensor(anchors).to(device=corpus.device,
                                            dtype=torch.float32),
        sketch=feats, sq=torch.sum(feats * feats, dim=1), seed=int(seed),
        gamma=gamma)


# ---------------------------------------------------------------------------
# Query path: matmul shortlist -> exact re-rank
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32_matmul():
    """Full FP32 matmuls (no TF32) for the length of the block, whatever
    the caller's setting; restored on exit."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def sketch_shortlist(q_feats: torch.Tensor, si: SketchIndex,
                     top_c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-C sketch-nearest candidates per query row.

    The score is the squared Euclidean distance between sketch rows,
    ``||q||^2 + ||s_n||^2 - 2 q.s_n``, with the per-row ``||q||^2``
    dropped: the cross term is one (B, R) x (R, N) FP32 matmul. A stable
    sort keeps the lower candidate index first among equal scores (as
    ``jax.lax.top_k`` does). Returns (cand, score): (B, C) int32
    candidate indices by ascending sketch distance, and their scores.
    """
    with _fp32_matmul():
        score = si.sq[None, :] - 2.0 * torch.matmul(q_feats, si.sketch.T)
    top_c = int(min(top_c, si.size))
    score, cand = torch.sort(score, dim=1, stable=True)
    return cand[:, :top_c].to(torch.int32), score[:, :top_c]


def _keogh_gathered(A: torch.Tensor, L: torch.Tensor, U: torch.Tensor,
                    wmin) -> torch.Tensor:
    """Support-windowed LB_Keogh on gathered pairs.

    A: (B, C, T) or (B, 1, T) series values; L, U envelopes broadcast
    against A; wmin: (T,) admissible per-row weight floor. Returns
    (B, C). Rows with empty support windows (wmin == +INF) force +INF.
    """
    wmin = torch.as_tensor(np.asarray(wmin, np.float32), device=A.device)
    above = torch.clamp_min(A - U, 0.0)
    below = torch.clamp_min(L - A, 0.0)
    pen = above * above + below * below                          # (B, C, T)
    dead = wmin >= INF
    term = torch.where(dead, torch.full_like(pen, INF),
                       torch.where(dead, torch.zeros_like(wmin), wmin) * pen)
    return torch.clamp_max(torch.sum(term, dim=2), INF)


def _now(device) -> float:
    # the caller's stream only: a learner refreshing on a stream of its
    # own must not stall the serving stage's clock
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return time.time()


def sketch_knn(Q: torch.Tensor, index, *, top_c: Optional[int] = None,
               approx: bool = False, impl: str = "auto",
               return_stats: bool = False):
    """Sub-linear 1-NN: sketch shortlist -> exact re-rank.

    Q: (B, T) on the index's device; ``index`` is a ``CorpusIndex``
    whose ``sketch`` holds a fitted ``SketchIndex`` (``fit`` a spec with
    ``sketch_r > 0``). Stages:

      1. embed the queries against the anchors (K1, or K7 when soft);
      2. score all N candidates with one matmul, keep the top-C (default
         max(8, N // 16));
      3. (``approx=True`` stops here: the sketch-nearest candidate with
         its exact distance, one K2 DP per query);
      4. re-rank: the exact DP on the sketch-nearest candidate seeds the
         threshold; LB_Kim and support-windowed LB_Keogh (both
         orientations) prune the rest of the shortlist; the survivors
         run K2 with the thresholds. Admissible bounds, strict
         abandoning and the first-index argmin make the result equal to
         the exact cascade's whenever the shortlist holds the true
         neighbour.

    Returns (nn_idx int32, nn_dist[, stats]); the stats carry the
    wall-clock of each stage (t_embed_s / t_shortlist_s / t_rerank_s).
    """
    from repro_torch.kernels import backends as bk
    from repro_torch.kernels.ops import _pair_dp
    from . import bounds as _bounds
    si = index.sketch
    if si is None:
        raise ValueError("no sketch on this index: fit a MeasureSpec with "
                         "sketch_r > 0")
    C = index.corpus
    dev = C.device
    Q = Q.to(device=dev, dtype=torch.float32)
    if Q.ndim != 2:
        raise ValueError("the sketch tier is univariate (like the "
                         "cascade): (B, T)")
    B = Q.shape[0]
    N = si.size
    impl_r = bk.resolve(impl, device=dev,
                        require=(bk.EARLY_ABANDON, bk.PRUNED_DP)).name
    timed = return_stats

    t0 = _now(dev) if timed else 0.0
    q_feats = sketch_embed(Q, si.anchors, bsp=index.bsp,
                           weights=index.weights, gamma=si.gamma, impl=impl)
    t1 = _now(dev) if timed else 0.0

    top_c = int(min(N, max(1, top_c if top_c is not None
                           else max(8, N // 16))))
    cand, _ = sketch_shortlist(q_feats, si, top_c)               # (B, C)
    t2 = _now(dev) if timed else 0.0

    cl = cand.long()
    best = cand[:, 0]
    d_best = _pair_dp(Q, C[cl[:, 0]], index, impl_r)              # (B,)

    if approx:
        if not return_stats:
            return best, d_best
        stats = {"n_queries": B, "n_candidates": N, "shortlist_c": top_c,
                 "mode": "approx", "dp_pairs": B,
                 "pre_dp_prune": 1.0 - 1.0 / N,
                 "shortlist_prune": 1.0 - top_c / N,
                 "t_embed_s": t1 - t0, "t_shortlist_s": t2 - t1,
                 "t_rerank_s": _now(dev) - t2}
        return best, d_best, stats

    thr = d_best
    # ---- bounds on the gathered shortlist, a block of queries at a time
    q_lo, q_hi = _bounds.envelopes(Q, index.lo_t, index.hi_t)    # (B, T)
    rows = max(1, _RERANK_CHUNK // max(1, top_c * Q.shape[1]))
    lbs = []
    for s in range(0, B, rows):
        q, c = Q[s:s + rows], cl[s:s + rows]
        g = C[c]                                                 # (b, C, T)
        lb = index.w00 * (q[:, None, 0] - g[:, :, 0]) ** 2 + \
            index.wTT * (q[:, None, -1] - g[:, :, -1]) ** 2
        lb = torch.maximum(lb, _keogh_gathered(
            q[:, None, :], index.env_lo[c], index.env_hi[c],
            index.wmin_rows))
        lbs.append(torch.maximum(lb, _keogh_gathered(
            g, q_lo[s:s + rows, None, :], q_hi[s:s + rows, None, :],
            index.wmin_cols)))
    lb = torch.cat(lbs, dim=0)
    alive = lb <= thr[:, None]
    alive[:, 0] = False                       # col 0 already exact

    # ---- survivor DPs with early abandoning (gathered) ----
    d_short = torch.full((B, top_c), INF, dtype=torch.float32, device=dev)
    d_short[:, 0] = d_best
    qi, ci = torch.nonzero(alive, as_tuple=True)
    if len(qi):
        d_short[qi, ci] = _pair_dp(Q[qi], C[cl[qi, ci]], index, impl_r,
                                   thresholds=thr[qi])

    # scatter into corpus order: argmin keeps the first-corpus-index tie
    # rule of the exact cascade
    D = torch.full((B, N), INF, dtype=torch.float32, device=dev)
    D.scatter_(1, cl, d_short)
    nn = torch.argmin(D, dim=1).to(torch.int32)
    nnd = D.gather(1, nn[:, None].long())[:, 0]
    if not return_stats:
        return nn, nnd
    dp_pairs = int(alive.sum()) + B
    stats = {
        "n_queries": B, "n_candidates": N, "shortlist_c": top_c,
        "mode": "sketch", "dp_pairs": dp_pairs,
        "shortlist_prune": 1.0 - top_c / N,
        "bound_prune": 1.0 - (dp_pairs / B - 1) / max(top_c - 1, 1)
        if top_c > 1 else 0.0,
        "pre_dp_prune": 1.0 - dp_pairs / (B * N),
        "t_embed_s": t1 - t0, "t_shortlist_s": t2 - t1,
        "t_rerank_s": _now(dev) - t2,
    }
    return nn, nnd, stats
