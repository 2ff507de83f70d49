"""Execute-layer bodies the fitted engine calls: pairs, Gram, 1-NN cascade.

The counterpart of the min-plus half of ``repro.kernels.ops``. Every
``impl=`` argument goes through ``backends.resolve`` with the device of
the call's tensors: ``cuda`` runs the hand-written kernels K1
(``gram_block.gram_spdtw_block``) and K2 (``spdtw_block.spdtw_block``),
``scan`` the plain PyTorch tile engines, ``dense`` the dense core DPs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bounds as _bounds
from repro_torch.core.dtw import INF
from repro_torch.core.measures import CorpusIndex
from repro_torch.core.occupancy import BlockSparsePaths, SparsePaths
from . import backends as bk
from . import ref
from .gram_block import (gram_prefix_bound, gram_spdtw_block,
                         gram_spdtw_scan, prefix_tile_count,
                         spdtw_paired_scan)
from .spdtw_block import spdtw_block


# ---------------------------------------------------------------------------
# Batched aligned pairs
# ---------------------------------------------------------------------------

def _dtw_pairs(x: torch.Tensor, y: torch.Tensor,
               impl: str = "auto") -> torch.Tensor:
    backend = bk.resolve(impl, device=x.device).name
    if backend == "cuda":
        raise NotImplementedError(
            "DTW over aligned pairs runs the anti-diagonal wavefront kernel "
            "(repro.kernels.dtw_wavefront), which this port does not have "
            "yet; use gram, or CPU tensors")
    return ref.dtw_batch(x, y)


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

    (1) banded LB_Kim endpoint bound; (2) support-windowed LB_Keogh
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
    if centroid_model is not None:
        raise NotImplementedError("the centroid-seeded stage 0 needs the "
                                  "soft-SP-DTW centroids, not ported yet")
    C = index.corpus
    Q = Q.to(device=C.device, dtype=torch.float32)
    Nq, T = Q.shape[:2]
    Nc = C.shape[0]
    seed_k = min(seed_k, Nc)
    require = (bk.MULTIVARIATE,) if bk.series_dim(Q) > 1 else ()
    if impl != "dense":
        require += (bk.EARLY_ABANDON, bk.PRUNED_DP)
    impl_r = bk.resolve(impl, device=Q.device, require=require).name

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

    # --- survivors so far: bound <= threshold (non-strict keeps ties) ---
    rows = torch.arange(Nq, device=Q.device)[:, None]
    alive2 = lb2 <= thr[:, None]
    alive2[rows, seed_idx] = False                              # known

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
    dp_pairs = int(alive.sum()) + Nq * seed_k
    abandoned = alive & ((D if G_ab is None else G_ab) >= 1e29)

    def frac(m):
        return float(m.to(torch.float32).mean())

    stats = {
        "n_queries": Nq, "n_candidates": Nc, "seed_k": seed_k,
        "n_centroids": 0,
        "prefix_tiles": n_prefix, "plan_tiles": index.bsp.n_active,
        "stage1_prune": frac(lb1 > thr[:, None]),
        "stage2_prune": frac(lb2 > thr[:, None]),
        "stage3_prune": frac(lb3 > thr[:, None]),
        "pre_dp_prune": 1.0 - dp_pairs / total,
        "dp_pairs": dp_pairs,
        "dp_abandoned": frac(abandoned),
    }
    return nn, nnd, stats
