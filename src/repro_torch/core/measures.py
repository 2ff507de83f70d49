"""Index layer: the build-once per-corpus search index.

The counterpart of ``repro.core.measures.CorpusIndex`` /
``build_corpus_index`` for the min-plus cascade
(``repro_torch.kernels.ops._knn_cascade``) and the log-semiring kernel
cascade (``_krdtw_knn_cascade``). The static artifacts (weight
grid, tile plan, support windows, endpoint weights) describe the measure;
the envelopes are per-candidate rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import bounds
from .occupancy import BlockSparsePaths, block_sparsify, default_tile


@dataclasses.dataclass(frozen=True)
class CorpusIndex:
    """Everything the lower-bound cascade needs about a fixed corpus.

    kind:            "dtw", "spdtw", "krdtw" or "sp_krdtw".
    corpus:          (Nc, T[, d]) f32 candidate set, on the index device.
    weights:         dense (T, T) weight grid (0 = outside the support),
                     on the index device.
    bsp:             the block-sparse tile plan, built once.
    lo, hi:          (T,) per-row support column windows (host).
    wmin_rows:       (T,) admissible per-row weight floor (host).
    env_lo, env_hi:  windowed candidate envelopes (LB_Keogh), like corpus.
    lo_t, hi_t,
    wmin_cols:       the per-column counterparts; the cascade envelopes
                     the *query* under these for the reverse Keogh bound.
    w00, wTT:        endpoint weights (LB_Kim).
    nu, log_s1,
    log_s2:          kernel-measure bound terms (DESIGN.md §14): for
                     krdtw / sp_krdtw indexes the bandwidth and the
                     proven K1/K2 slacks of the log-semiring lower bound
                     (``bounds.krdtw_log_slacks``); 0.0 for the min-plus
                     measures.
    """
    kind: str
    corpus: torch.Tensor
    weights: torch.Tensor
    bsp: BlockSparsePaths
    lo: np.ndarray
    hi: np.ndarray
    wmin_rows: np.ndarray
    env_lo: torch.Tensor
    env_hi: torch.Tensor
    lo_t: np.ndarray
    hi_t: np.ndarray
    wmin_cols: np.ndarray
    w00: float
    wTT: float
    nu: float = 0.0
    log_s1: float = 0.0
    log_s2: float = 0.0

    @property
    def size(self) -> int:
        """Number of indexed corpus series."""
        return int(self.corpus.shape[0])

    @property
    def device(self) -> torch.device:
        """Device the corpus rows live on."""
        return self.corpus.device


def build_corpus_index(corpus: torch.Tensor, weights,
                       kind: str = "spdtw",
                       bsp: Optional[BlockSparsePaths] = None,
                       tile: Optional[int] = None,
                       nu: Optional[float] = None) -> CorpusIndex:
    """Construct the search index for a corpus under a (T, T) weight grid.

    ``corpus`` (Nc, T) or (Nc, T, d) is indexed on its own device;
    ``weights`` may be a tensor or an array (its host copy drives the
    windows and the plan). Kernel kinds (krdtw / sp_krdtw) need the
    bandwidth ``nu``: the K1/K2 slacks of their bound are computed here,
    once, from the support.
    """
    if isinstance(weights, torch.Tensor):
        w = weights.detach().cpu().numpy().astype(np.float32)
    else:
        w = np.asarray(weights, np.float32)
    corpus = corpus.to(torch.float32)
    T = w.shape[0]
    support = w > 0
    lo, hi = bounds.support_extents(support)
    lo_t, hi_t = bounds.support_extents(support.T)
    wmin_rows = bounds.row_min_weights(w)
    wmin_cols = bounds.row_min_weights(w.T)
    env_lo, env_hi = bounds.envelopes(corpus, lo, hi)
    if bsp is None:
        bsp = block_sparsify(w, tile=tile or default_tile(T))
    log_s1 = log_s2 = 0.0
    if kind in ("krdtw", "sp_krdtw"):
        if nu is None:
            raise ValueError("kernel indexes need the bandwidth nu")
        log_s1, log_s2 = bounds.krdtw_log_slacks(
            support if kind == "sp_krdtw" else None, T=T)
    return CorpusIndex(
        kind=kind, corpus=corpus,
        weights=torch.as_tensor(w, device=corpus.device), bsp=bsp,
        lo=lo, hi=hi, wmin_rows=wmin_rows, env_lo=env_lo, env_hi=env_hi,
        lo_t=lo_t, hi_t=hi_t, wmin_cols=wmin_cols,
        w00=float(w[0, 0]), wTT=float(w[-1, -1]),
        nu=float(nu or 0.0), log_s1=log_s1, log_s2=log_s2)
