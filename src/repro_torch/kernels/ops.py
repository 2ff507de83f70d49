"""Execute-layer bodies the fitted engine calls: pairs, Gram, 1-NN cascades.

The counterpart of ``repro.kernels.ops``. Every ``impl=`` argument goes
through ``backends.resolve`` with the device of the call's tensors:
``cuda`` runs the hand-written kernels, ``scan`` the plain PyTorch tile
engines and the core oracles, ``dense`` the dense core DPs. On ``cuda``:

  K1 ``gram_block.gram_spdtw_block``       SP-DTW / DTW Gram, prefix bound
  K2 ``spdtw_block.spdtw_block``           aligned-pair SP-DTW
  K3 ``gram_block.gram_log_krdtw_block``   log K_rdtw Gram
  K4 ``krdtw_wavefront.wavefront_log_krdtw``  aligned-pair log K_rdtw
  K5 ``dtw_wavefront.wavefront_dtw``       aligned-pair DTW / DTW_sc
  K6 ``dtw_banded.banded_dtw[_gram]``      DTW_sc pairs and Gram
  K7-K9 ``soft_block``                    the soft-SP-DTW layer (through
                                          the engine's soft methods)

A CUDA tensor reaches one of them or an exception, never a plain
version.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import baselines as _baselines
from repro_torch.core import bounds as _bounds
from repro_torch.core.dtw import INF, band_mask
from repro_torch.core.measures import CorpusIndex
from repro_torch.core.occupancy import BlockSparsePaths, SparsePaths
from . import backends as bk
from . import ref
from .dtw_banded import banded_dtw, banded_dtw_gram
from .dtw_wavefront import wavefront_dtw
from .gram_block import (gram_log_krdtw_block, gram_prefix_bound,
                         gram_spdtw_block, gram_spdtw_scan,
                         prefix_tile_count, spdtw_paired_scan)
from .krdtw_wavefront import mask_to_diagonal_major, wavefront_log_krdtw
from .spdtw_block import spdtw_block


# ---------------------------------------------------------------------------
# Batched aligned pairs
# ---------------------------------------------------------------------------

def _dtw_pairs(x: torch.Tensor, y: torch.Tensor, impl: str = "auto",
               radius: Optional[int] = None) -> torch.Tensor:
    """Batched DTW, optionally Sakoe-Chiba banded: K5 on ``cuda`` (any
    channel count), the dense core DP on ``scan`` / ``dense``."""
    backend = bk.resolve(impl, device=x.device).name
    if backend in ("scan", "dense"):
        if radius is None:
            return ref.dtw_batch(x, y)
        return ref.dtw_band_batch(x, y, radius)
    return wavefront_dtw(x, y, radius=radius)


def dtw_banded_pairs(x: torch.Tensor, y: torch.Tensor, radius: int,
                     impl: str = "auto") -> torch.Tensor:
    """Batched banded DTW via the slanted-strip kernel K6 (O(T (2r+1))
    work) on ``cuda``; the dense core DP on ``scan`` / ``dense``."""
    backend = bk.resolve(impl, device=x.device).name
    if backend in ("scan", "dense"):
        return ref.dtw_band_batch(x, y, radius)
    return banded_dtw(x, y, radius)


def _log_krdtw_pairs(x: torch.Tensor, y: torch.Tensor, nu: float,
                     radius: Optional[int] = None,
                     support: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> torch.Tensor:
    """Batched log K_rdtw / K_rdtw_sc / SP-K_rdtw: K4 on ``cuda``
    (univariate: K4 raises on (B, T, d)), the core row recursion on
    ``scan`` / ``dense``."""
    backend = bk.resolve(impl, device=x.device).name
    if backend in ("scan", "dense"):
        if support is not None:
            return ref.log_krdtw_masked_batch(x, y, nu, support)
        if radius is not None:
            return ref.log_krdtw_band_batch(x, y, nu, radius)
        return ref.log_krdtw_batch(x, y, nu)
    mask_diag = None
    if support is not None:
        mask_diag = mask_to_diagonal_major(_host_bool(support))
    return wavefront_log_krdtw(x, y, nu, radius=radius, mask_diag=mask_diag)


def _host_bool(support) -> np.ndarray:
    if isinstance(support, torch.Tensor):
        support = support.detach().cpu().numpy()
    return np.asarray(support, bool)


def _spdtw_pairs(x: torch.Tensor, y: torch.Tensor,
                 sp: Optional[SparsePaths] = None,
                 bsp: Optional[BlockSparsePaths] = None,
                 impl: str = "auto") -> torch.Tensor:
    backend = bk.resolve(impl, device=x.device).name
    if backend in ("scan", "dense"):
        # the dense masked DP, as the reference's scan/dense route
        return ref.wdtw_batch(x, y, bk.resolve_dense_weights(
            sp, bsp, T=x.shape[1], device=x.device))
    return spdtw_block(x, y, bk.resolve_plan(sp, bsp), T_orig=x.shape[1])


# ---------------------------------------------------------------------------
# All-pairs Gram engines
# ---------------------------------------------------------------------------

def _spdtw_gram(A: torch.Tensor, B: torch.Tensor, *,
                sp: Optional[SparsePaths] = None,
                bsp: Optional[BlockSparsePaths] = None,
                weights: Optional[torch.Tensor] = None,
                impl: str = "auto", block_a: int = 64,
                thresholds: Optional[torch.Tensor] = None,
                alive0: Optional[torch.Tensor] = None) -> torch.Tensor:
    require = (bk.MULTIVARIATE,) if bk.series_dim(A) > 1 else ()
    backend = bk.resolve(impl, device=A.device, require=require).name
    if backend == "dense":
        w = bk.resolve_dense_weights(sp, bsp, weights, T=A.shape[1],
                                     device=A.device)
        out = ref.wdtw_cross(A, B, w)
        if alive0 is not None:
            out = torch.where(alive0.bool(), out, torch.full_like(out, INF))
        return out
    bspr = bk.resolve_plan(sp, bsp, weights)
    if backend == "scan":
        return gram_spdtw_scan(A, B, bspr, T_orig=A.shape[1],
                               block_a=block_a, thresholds=thresholds,
                               alive0=alive0)
    return gram_spdtw_block(A, B, bspr, T_orig=A.shape[1],
                            thresholds=thresholds, alive0=alive0)


def _dtw_gram(A: torch.Tensor, B: torch.Tensor, *,
              impl: str = "auto") -> torch.Tensor:
    backend = bk.resolve(impl, device=A.device).name
    if backend in ("scan", "dense"):
        return ref.wdtw_cross(A, B, None)
    # DTW is SP-DTW over the all-ones plan
    return gram_spdtw_block(A, B, bk.resolve_plan(T=A.shape[1]),
                            T_orig=A.shape[1])


def _dtw_sc_gram(A: torch.Tensor, B: torch.Tensor, radius: int, *,
                 impl: str = "auto") -> torch.Tensor:
    """(Na, Nb) Sakoe-Chiba DTW: K6's Gram mode on ``cuda``, the dense
    core DP over all pairs (the reference's chunked single-pair
    ``dtw_sc``) on ``scan`` / ``dense``."""
    backend = bk.resolve(impl, device=A.device).name
    if backend in ("scan", "dense"):
        return ref.dtw_band_cross(A, B, radius)
    return banded_dtw_gram(A, B, radius)


def _log_krdtw_gram(A: torch.Tensor, B: torch.Tensor, nu: float, *,
                    support: Optional[torch.Tensor] = None,
                    radius: Optional[int] = None,
                    impl: str = "auto") -> torch.Tensor:
    """(Na, Nb) log K_rdtw / K_rdtw_sc / SP-K_rdtw Gram: K3 on ``cuda``
    (univariate: K3 raises on (N, T, d)); on ``scan`` / ``dense`` the core
    row recursion over all pairs with the corridor folded into the
    support mask."""
    backend = bk.resolve(impl, device=A.device).name
    if backend in ("scan", "dense"):
        sup = None if support is None else \
            torch.as_tensor(_host_bool(support), device=A.device)
        if radius is not None:
            band = band_mask(A.shape[1], B.shape[1], radius, device=A.device)
            sup = band if sup is None else sup & band
        return ref.log_krdtw_cross(A, B, nu, sup)
    return gram_log_krdtw_block(A, B, nu, support=support, radius=radius)


# ---------------------------------------------------------------------------
# Baseline measures (plain PyTorch in the reference too: no kernel)
# ---------------------------------------------------------------------------

def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) if x.ndim == 3 else x


def _baseline_pairs(family: str, x: torch.Tensor, y: torch.Tensor,
                    lags: int = 10) -> torch.Tensor:
    """Aligned-pair euclidean / 1 - CORR / DACO: (B, T) -> (B,)."""
    if family == "euclidean":
        return _baselines.euclidean(_flat(x), _flat(y))
    if family == "corr":
        return _baselines.corr_dissimilarity(x, y)
    if family == "daco":
        return _baselines.daco(x, y, lags)
    raise ValueError(f"{family!r} is not a baseline measure")


def _baseline_gram(family: str, A: torch.Tensor, B: torch.Tensor,
                   lags: int = 10, block: int = 128) -> torch.Tensor:
    """(Na, Nb) baseline dissimilarities, A rows in chunks of ``block``."""
    rows = []
    for s in range(0, A.shape[0], block):
        a = A[s:s + block]
        x = a.repeat_interleave(B.shape[0], dim=0)
        y = B.repeat((a.shape[0],) + (1,) * (B.ndim - 1))
        rows.append(_baseline_pairs(family, x, y, lags)
                    .reshape(a.shape[0], B.shape[0]))
    if not rows:
        return torch.empty((0, B.shape[0]), dtype=torch.float32,
                           device=A.device)
    return torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# Lower-bound cascade: exact 1-NN without paying the DP per candidate
# ---------------------------------------------------------------------------

def _pair_dp(x: torch.Tensor, y: torch.Tensor, index: CorpusIndex,
             impl: str,
             thresholds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched aligned-pair SP-DTW for the cascade's seed and survivor
    stages: "dense" the dense masked DP, "scan" the plain paired engine,
    "cuda" K2."""
    if impl == "dense":
        return ref.wdtw_batch(x, y, index.weights)
    if impl == "scan":
        return spdtw_paired_scan(x, y, index.bsp, T_orig=x.shape[1],
                                 thresholds=thresholds)
    return spdtw_block(x, y, index.bsp, T_orig=x.shape[1],
                       thresholds=thresholds)


def _knn_cascade(Q: torch.Tensor, index: CorpusIndex, *, impl: str = "auto",
                 seed_k: int = 2, prefix_frac: float = 0.5,
                 block_a: int = 64, return_stats: bool = False,
                 centroid_model=None):
    """Exact 1-NN of queries against an indexed corpus (DESIGN.md §4).

    (0) with a ``centroid_model`` carrying medoids, the exact distance to
    the medoid of each query's nearest centroid (K1 Gram against the k
    centroids, K2 on the medoid pairs) seeds the threshold; (1) banded LB_Kim endpoint bound; (2) support-windowed LB_Keogh
    envelopes, both orientations; seed each query's threshold with the
    exact distance of its ``seed_k`` best-bounded candidates; (3) the
    truncated prefix-DP bound over the first ``prefix_frac`` of the tile
    rows; (4) the exact DP on the survivors with early abandoning. On
    ``cuda`` stage 3 is K1's prefix mode, the seeds run K2, and stage 4
    runs K1 with the thresholds and the survivor mask; on ``scan`` stage 4
    gathers the survivors through the plain paired engine. All bounds are
    admissible and thresholds are exact distances of real candidates, so
    the neighbours equal a full Gram argmin bit for bit, first index on
    ties. Returns (nn int32, nn_dist[, stats]).
    """
    C = index.corpus
    Q = Q.to(device=C.device, dtype=torch.float32)
    Nq, T = Q.shape[:2]
    Nc = C.shape[0]
    seed_k = min(seed_k, Nc)
    require = (bk.MULTIVARIATE,) if bk.series_dim(Q) > 1 else ()
    if impl != "dense":
        require += (bk.EARLY_ABANDON, bk.PRUNED_DP)
    impl_r = bk.resolve(impl, device=Q.device, require=require).name

    # --- stage 0: centroid-seeded threshold (k + 1 DPs per query): the
    # exact distance to the medoid of each query's nearest centroid ---
    cand = d_cand = None
    n_centroids = 0
    if centroid_model is not None and \
            getattr(centroid_model, "medoids", None) is not None:
        Z = centroid_model.centroids.to(device=Q.device, dtype=torch.float32)
        n_centroids = int(Z.shape[0])
        Dc = _spdtw_gram(Q, Z, bsp=index.bsp, weights=index.weights,
                         impl=impl_r, block_a=block_a)
        best_c = torch.argmin(Dc, dim=1)
        cand = torch.as_tensor(np.asarray(centroid_model.medoids),
                               dtype=torch.long, device=Q.device)[best_c]
        d_cand = _pair_dp(Q, C[cand], index, impl_r)

    # --- stage 1: banded endpoint bound ---
    lb1 = _bounds.lb_kim_band_cross(Q, C, index.lo, index.hi,
                                    index.wmin_rows, index.w00, index.wTT)
    # --- stage 2: support-windowed envelopes, both orientations ---
    lb2 = torch.maximum(lb1, _bounds.lb_keogh_cross(
        Q, index.env_lo, index.env_hi, index.wmin_rows))
    q_lo, q_hi = _bounds.envelopes(Q, index.lo_t, index.hi_t)
    lb2 = torch.maximum(lb2, _bounds.lb_keogh_cross(
        C, q_lo, q_hi, index.wmin_cols).T)

    # --- seed thresholds: exact DP on the seed_k best-bounded candidates
    # (a stable sort keeps the lower index first among equal bounds) ---
    seed_idx = torch.sort(lb2, dim=1, stable=True).indices[:, :seed_k]
    xq = Q.repeat_interleave(seed_k, dim=0)
    yc = C[seed_idx.reshape(-1)]
    seed_d = _pair_dp(xq, yc, index, impl_r).reshape(Nq, seed_k)
    thr = seed_d.amin(dim=1)                                    # (Nq,)
    if d_cand is not None:
        thr = torch.minimum(thr, d_cand)

    # --- survivors so far: bound <= threshold (non-strict keeps ties) ---
    rows = torch.arange(Nq, device=Q.device)[:, None]
    alive2 = lb2 <= thr[:, None]
    alive2[rows, seed_idx] = False                              # known
    if cand is not None:
        alive2[rows[:, 0], cand] = False

    # --- stage 3: truncated prefix-DP bound on the block plan ---
    n_prefix = prefix_tile_count(index.bsp, prefix_frac, T)
    if n_prefix > 0 and impl_r != "dense":
        if impl_r == "cuda":
            lb3 = gram_spdtw_block(Q, C, index.bsp, T_orig=T,
                                   n_prefix=n_prefix)
        else:
            lb3 = gram_prefix_bound(Q, C, index.bsp, n_prefix, T_orig=T,
                                    block_a=block_a)
        alive = alive2 & (lb3 <= thr[:, None])
    else:
        lb3 = lb2
        alive = alive2

    # --- stage 4: exact DP on the survivors, early abandoning ---
    D = torch.full((Nq, Nc), INF, dtype=torch.float32, device=Q.device)
    D[rows, seed_idx] = seed_d
    if cand is not None:
        D[rows[:, 0], cand] = d_cand
    G_ab = None
    if impl_r == "scan":
        # gather the survivors: the DP only ever touches those pairs
        qi, ci = torch.nonzero(alive, as_tuple=True)
        if len(qi):
            D[qi, ci] = _pair_dp(Q[qi], C[ci], index, impl_r,
                                 thresholds=thr[qi])
    else:
        G_ab = _spdtw_gram(Q, C, bsp=index.bsp, weights=index.weights,
                           impl=impl_r, block_a=block_a, thresholds=thr,
                           alive0=alive)
        D = torch.where(alive, G_ab, D)
    nn = torch.argmin(D, dim=1).to(torch.int32)
    nnd = D.gather(1, nn[:, None].long())[:, 0]
    if not return_stats:
        return nn, nnd
    total = Nq * Nc
    dp_pairs = int(alive.sum()) + Nq * (
        seed_k + (n_centroids + 1 if cand is not None else 0))
    abandoned = alive & ((D if G_ab is None else G_ab) >= 1e29)

    def frac(m):
        return float(m.to(torch.float32).mean())

    stats = {
        "n_queries": Nq, "n_candidates": Nc, "seed_k": seed_k,
        "n_centroids": n_centroids,
        "prefix_tiles": n_prefix, "plan_tiles": index.bsp.n_active,
        "stage1_prune": frac(lb1 > thr[:, None]),
        "stage2_prune": frac(lb2 > thr[:, None]),
        "stage3_prune": frac(lb3 > thr[:, None]),
        "pre_dp_prune": 1.0 - dp_pairs / total,
        "dp_pairs": dp_pairs,
        "dp_abandoned": frac(abandoned),
    }
    return nn, nnd, stats


# ---------------------------------------------------------------------------
# Log-semiring cascade: exact kernel 1-NN for krdtw / sp_krdtw
# ---------------------------------------------------------------------------

def _krdtw_pair_eval(x: torch.Tensor, y: torch.Tensor, index: CorpusIndex,
                     impl: str) -> torch.Tensor:
    """Exact kernel dissimilarity -log K_rdtw for aligned pair batches (K4
    on ``cuda``)."""
    sup = None if index.kind == "krdtw" else (index.weights > 0)
    return -_log_krdtw_pairs(x, y, index.nu, support=sup, impl=impl)


def _krdtw_knn_cascade(Q: torch.Tensor, index: CorpusIndex, *,
                       impl: str = "auto", seed_k: int = 2,
                       prefix_frac: float = 0.5, block_a: int = 64,
                       return_stats: bool = False):
    """Exact kernel 1-NN under the dissimilarity -log K_rdtw (DESIGN.md
    §14).

    The bound stage runs in the log semiring: K1 / K2 are bounded by their
    proven slacks times exp(-nu * b), b an admissible min-plus bound on
    the unit-weight masked path cost, so the Kim / Keogh / prefix bounds
    run unchanged on the kernel index (unit weights over the support).
    Seeds (``seed_k`` best-bounded candidates per query, a stable sort:
    the lower index first among equal bounds) and survivors run K4 on
    ``cuda``, the prefix bound K1's prefix mode over the unit-weight
    plan. Thresholds are exact dissimilarities of real candidates and the
    bound is admissible, so the neighbours equal the ``-gram_log``
    argmin bit for bit (K3 and K4 agree bit for bit). As in the
    reference, ``stage1_prune`` is computed from the stage-2 bound.
    Returns (nn int32, nn_dist[, stats]).
    """
    if Q.ndim != 2:
        raise ValueError("the kernel measures are univariate: (Nq, T)")
    C = index.corpus
    Q = Q.to(device=C.device, dtype=torch.float32)
    Nq, T = Q.shape
    Nc = C.shape[0]
    seed_k = min(seed_k, Nc)
    impl_r = bk.resolve(impl, device=Q.device).name
    nu = index.nu

    # --- min-plus bound b1 on the unit-weight masked path cost ---
    b1 = _bounds.lb_kim_band_cross(Q, C, index.lo, index.hi,
                                   index.wmin_rows, index.w00, index.wTT)
    b1 = torch.maximum(b1, _bounds.lb_keogh_cross(
        Q, index.env_lo, index.env_hi, index.wmin_rows))
    q_lo, q_hi = _bounds.envelopes(Q, index.lo_t, index.hi_t)
    b1 = torch.maximum(b1, _bounds.lb_keogh_cross(
        C, q_lo, q_hi, index.wmin_cols).T)
    # --- b2: every K2 path pays the aligned endpoint factors ---
    b2 = (Q[:, 0, None] - C[None, :, 0]) ** 2
    if T > 1:
        b2 = b2 + (Q[:, -1, None] - C[None, :, -1]) ** 2
    lb2 = _bounds.lb_log_krdtw(b1, b2, nu, index.log_s1, index.log_s2)

    # --- seed thresholds: exact -log K on the best-bounded candidates ---
    seed_idx = torch.sort(lb2, dim=1, stable=True).indices[:, :seed_k]
    xq = Q.repeat_interleave(seed_k, dim=0)
    yc = C[seed_idx.reshape(-1)]
    seed_d = _krdtw_pair_eval(xq, yc, index, impl_r).reshape(Nq, seed_k)
    thr = seed_d.amin(dim=1)                                    # (Nq,)

    rows = torch.arange(Nq, device=Q.device)[:, None]
    alive2 = lb2 <= thr[:, None]
    alive2[rows, seed_idx] = False                              # known

    # --- prefix-DP tightens b1 (min-plus sweep on the unit-weight plan) ---
    n_prefix = prefix_tile_count(index.bsp, prefix_frac, T)
    if n_prefix > 0 and impl_r != "dense":
        if impl_r == "cuda":
            pb = gram_spdtw_block(Q, C, index.bsp, T_orig=T,
                                  n_prefix=n_prefix)
        else:
            pb = gram_prefix_bound(Q, C, index.bsp, n_prefix, T_orig=T,
                                   block_a=block_a)
        lb3 = _bounds.lb_log_krdtw(torch.maximum(b1, pb), b2, nu,
                                   index.log_s1, index.log_s2)
        alive = alive2 & (lb3 <= thr[:, None])
    else:
        lb3 = lb2
        alive = alive2

    # --- exact -log K on the survivors (gathered: K4 on cuda) ---
    D = torch.full((Nq, Nc), INF, dtype=torch.float32, device=Q.device)
    D[rows, seed_idx] = seed_d
    qi, ci = torch.nonzero(alive, as_tuple=True)
    if len(qi):
        D[qi, ci] = _krdtw_pair_eval(Q[qi], C[ci], index, impl_r)
    nn = torch.argmin(D, dim=1).to(torch.int32)
    nnd = D.gather(1, nn[:, None].long())[:, 0]
    if not return_stats:
        return nn, nnd
    dp_pairs = int(alive.sum()) + Nq * seed_k

    def frac(m):
        return float(m.to(torch.float32).mean())

    stats = {
        "n_queries": Nq, "n_candidates": Nc, "seed_k": seed_k,
        "n_centroids": 0,
        "prefix_tiles": n_prefix, "plan_tiles": index.bsp.n_active,
        "stage1_prune": frac(lb2 > thr[:, None]),
        "stage2_prune": frac(lb2 > thr[:, None]),
        "stage3_prune": frac(lb3 > thr[:, None]),
        "pre_dp_prune": 1.0 - dp_pairs / (Nq * Nc),
        "dp_pairs": dp_pairs,
        "dp_abandoned": 0.0,
    }
    return nn, nnd, stats
