"""Measure stack: index -> plan -> execute.

The counterpart of ``repro.core.measures``:

  * ``pairwise`` is the unified all-pairs dispatch over the engine's Gram
    bodies in ``repro_torch.kernels.ops`` (K1 for spdtw / dtw, K3 for the
    K_rdtw kernels, on the card);
  * ``Measure`` / ``make_measure`` is the plain parameter record of one
    measure (paper Tables II, IV and VI read it): its visited cells, its
    pair and all-pairs evaluators and its cascade index;
  * ``CorpusIndex`` / ``build_corpus_index`` is the build-once per-corpus
    search index of the min-plus cascade (``ops._knn_cascade``) and the
    log-semiring kernel cascade (``ops._krdtw_knn_cascade``). The static
    artifacts (weight grid, tile plan, support windows, endpoint weights)
    describe the measure; the envelopes (and the sketch) are
    per-candidate rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import bounds
from .dtw import band_cells as _band_cells
from .occupancy import (BlockSparsePaths, SparsePaths, block_sparsify,
                        default_tile)


def _as_series(X, device) -> torch.Tensor:
    """X (a tensor or an array) as a float32 tensor on ``device``."""
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.array(X, np.float32))
    return X.to(device=device, dtype=torch.float32)


def pairwise(A, B, kind: str = "spdtw", *,
             sp: Optional[SparsePaths] = None,
             bsp: Optional[BlockSparsePaths] = None,
             weights=None, nu: float = 1.0, radius: Optional[int] = None,
             impl: str = "auto", block_a: int = 64,
             device=None) -> torch.Tensor:
    """Unified all-pairs engine: (Na, T) x (Nb, T) -> (Na, Nb) values.

    kind: "spdtw" / "dtw" return dissimilarities (K1 on the card, over
    the plan or the all-ones plan); "krdtw" / "sp_krdtw" return *log
    kernel* values (K3; callers negate for 1-NN). ``device`` is where to
    compute: ``cuda`` unless the caller names another.
    """
    from repro_torch.core.engine import resolve_device
    from repro_torch.kernels import ops
    dev = resolve_device(device)
    A, B = _as_series(A, dev), _as_series(B, dev)
    if kind == "spdtw":
        if weights is not None:
            weights = _as_series(weights, dev)
        return ops._spdtw_gram(A, B, sp=sp, bsp=bsp, weights=weights,
                               impl=impl, block_a=block_a)
    if kind == "dtw":
        return ops._dtw_gram(A, B, impl=impl)
    if kind in ("krdtw", "sp_krdtw"):
        support = None
        if kind == "sp_krdtw":
            if sp is not None:
                support = sp.support
            elif weights is not None:
                support = _as_series(weights, dev) > 0
            else:
                raise ValueError("sp_krdtw needs sp or weights")
        return ops._log_krdtw_gram(A, B, nu, support=support,
                                   radius=radius, impl=impl)
    raise ValueError(f"pairwise does not support kind {kind!r}")


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
    sketch:          optional ``core.sketch.SketchIndex``, the Random
                     Warping Series tier; attached by ``fit`` when the
                     spec asks for it (``sketch_r > 0``), else None.
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
    sketch: Optional[object] = None
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

    def take(self, sel) -> "CorpusIndex":
        """Candidate-sliced view of this index (the sharding primitive).

        ``sel`` is a slice or an integer row selector (repeats allowed).
        The statics (weight grid, tile plan, support windows, endpoint
        weights, kernel slacks) describe the measure and are shared by
        reference; only the per-candidate rows (corpus, envelopes, and
        the sketch's rows and squared norms) are sliced. Those rows are
        computed row by row, so a taken index equals an index rebuilt on
        the selected corpus rows, bit for bit.
        """
        if not isinstance(sel, slice):
            sel = torch.as_tensor(np.asarray(sel), dtype=torch.long,
                                  device=self.device)
        sk = self.sketch
        if sk is not None:
            sk = dataclasses.replace(sk, sketch=sk.sketch[sel], sq=sk.sq[sel])
        return dataclasses.replace(
            self, corpus=self.corpus[sel], env_lo=self.env_lo[sel],
            env_hi=self.env_hi[sel], sketch=sk)


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


# ---------------------------------------------------------------------------
# Measure: explicit parameter record + dispatch
# ---------------------------------------------------------------------------

_KERNELS = ("krdtw", "krdtw_sc", "sp_krdtw")
_SPARSE = ("spdtw", "sp_krdtw")
_BASELINES = ("euclidean", "corr", "daco")


@dataclasses.dataclass
class Measure:
    """One (dis)similarity measure with its meta-parameters baked in.

    ``cross`` / ``gram_log`` evaluate all pairs through the fitted
    engine's Gram bodies (``repro_torch.kernels.ops``): on the card K1
    for dtw (all-ones plan) and spdtw, K6 for dtw_sc, K3 for the K_rdtw
    kernels (full grid, corridor, learned support), and the baseline
    Grams for euclidean, corr and daco. ``pair`` / ``logk`` take one pair
    of (T,) series or a batch of aligned pairs (B, T[, d]): K5 for dtw /
    dtw_sc, K2 for spdtw, K4 for the kernels. ``build_index`` produces the
    cascade's index, ``visited_cells`` paper Table VI's accounting. The
    plan is built once at construction. Everything computes on
    ``device`` (``cuda`` unless the caller names another).
    """
    name: str
    T: int
    sp: Optional[SparsePaths] = None
    nu: float = 1.0
    radius: int = 10
    lags: int = 10
    bsp: Optional[BlockSparsePaths] = None
    visited_cells: Optional[int] = None
    device: Optional[torch.device] = None
    _indices: Dict[tuple, CorpusIndex] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        from repro_torch.core.engine import resolve_device
        if self.name not in ALL_MEASURES + ("dtw_sc", "krdtw_sc"):
            raise ValueError(f"unknown measure {self.name!r}")
        if self.name in _SPARSE and self.sp is None:
            raise ValueError(f"{self.name} needs a SparsePaths")
        self.device = resolve_device(self.device)
        if self.name == "spdtw" and self.bsp is None:
            # the plan layer: block-sparse tile schedule, built once
            self.bsp = block_sparsify(self.sp, tile=default_tile(self.T))
        if self.visited_cells is None:
            self.visited_cells = self._visited_cells()

    def _visited_cells(self) -> int:
        """Paper Table VI's '# visited cells' accounting."""
        n, T = self.name, self.T
        if n in ("euclidean", "corr"):
            return T
        if n == "daco":
            return T * self.lags
        if n in ("dtw_sc", "krdtw_sc"):
            return _band_cells(T, T, self.radius)
        if n in _SPARSE:
            return self.sp.n_cells
        return T * T                       # dtw, krdtw

    def _t(self, X) -> torch.Tensor:
        return _as_series(X, self.device)

    @property
    def _support(self) -> Optional[torch.Tensor]:
        return self.sp.support.to(self.device) if self.name == "sp_krdtw" \
            else None

    @property
    def _radius(self) -> Optional[int]:
        return self.radius if self.name in ("dtw_sc", "krdtw_sc") else None

    # ---- pair-level evaluators -------------------------------------------
    @property
    def is_kernel(self) -> bool:
        """True for similarity (log-kernel) measures; False for
        dissimilarities."""
        return self.name in _KERNELS

    def _batched(self, fn, x, y) -> torch.Tensor:
        x, y = self._t(x), self._t(y)
        if x.ndim == 1:
            return fn(x[None], y[None])[0]
        return fn(x, y)

    def pair(self, x, y) -> torch.Tensor:
        """Dissimilarity of one pair of (T,) series (a scalar) or of a
        batch of aligned pairs (B, T[, d]) -> (B,); kernels are
        negated."""
        from repro_torch.kernels import ops
        n = self.name
        if n in _KERNELS:
            return -self.logk(x, y)

        def fn(a, b):
            if n in _BASELINES:
                return ops._baseline_pairs(n, a, b, self.lags)
            if n in ("dtw", "dtw_sc"):
                return ops._dtw_pairs(a, b, radius=self._radius)
            return ops._spdtw_pairs(a, b, self.sp, bsp=self.bsp)
        return self._batched(fn, x, y)

    def logk(self, x, y) -> torch.Tensor:
        """Log kernel value of one pair (a scalar) or of a batch of
        aligned pairs (B,) (kernels only)."""
        from repro_torch.kernels import ops
        if not self.is_kernel:
            raise ValueError(f"{self.name} is not a kernel")
        return self._batched(
            lambda a, b: ops._log_krdtw_pairs(
                a, b, self.nu, radius=self._radius, support=self._support),
            x, y)

    @property
    def pair_fn(self) -> Callable:
        """(x, y) -> dissimilarity callable (kernels negated)."""
        return self.pair

    @property
    def logk_fn(self) -> Optional[Callable]:
        """(x, y) -> log-kernel callable; None for dissimilarity
        measures."""
        return self.logk if self.is_kernel else None

    # ---- all-pairs execute layer -----------------------------------------
    def cross(self, A, B, block: int = 128) -> torch.Tensor:
        """(Na, Nb) dissimilarity matrix through the engine's Grams."""
        from repro_torch.kernels import ops
        n = self.name
        A, B = self._t(A), self._t(B)
        if n == "dtw":
            return ops._dtw_gram(A, B)
        if n == "spdtw":
            return ops._spdtw_gram(A, B, sp=self.sp, bsp=self.bsp,
                                   block_a=block)
        if n == "dtw_sc":
            return ops._dtw_sc_gram(A, B, self.radius)
        if n in _KERNELS:
            return -self.gram_log(A, B, block)
        return ops._baseline_gram(n, A, B, self.lags, block=block)

    def gram_log(self, A, B, block: int = 128) -> torch.Tensor:
        """(Na, Nb) log Gram matrix (kernels only): K3 on the card."""
        from repro_torch.kernels import ops
        if not self.is_kernel:
            raise ValueError(f"{self.name} is not a kernel")
        return ops._log_krdtw_gram(self._t(A), self._t(B), self.nu,
                                   support=self._support,
                                   radius=self._radius)

    # ---- index layer ------------------------------------------------------
    @property
    def supports_cascade(self) -> bool:
        """True when the lower-bound cascade applies (the min-plus
        DPs)."""
        return self.name in ("dtw", "spdtw")

    _INDEX_CACHE_MAX = 4                   # corpora cached per measure

    def build_index(self, corpus, *, force: bool = False) -> CorpusIndex:
        """Build (once) and cache the search index for ``corpus``, keyed
        on its content (shape + byte hash); at most ``_INDEX_CACHE_MAX``
        corpora are kept (FIFO). ``force=True`` rebuilds."""
        if not self.supports_cascade:
            raise ValueError(f"{self.name} has no admissible lower bounds")
        corpus = self._t(corpus)
        key = (tuple(corpus.shape),
               hash(corpus.detach().cpu().numpy().tobytes()))
        if force or key not in self._indices:
            if self.name == "spdtw":
                w = self.sp.weights
            else:                          # plain dtw: all-ones support
                w = np.ones((self.T, self.T), np.float32)
                if self.bsp is None:
                    self.bsp = block_sparsify(w, tile=default_tile(self.T))
            while len(self._indices) >= self._INDEX_CACHE_MAX:
                self._indices.pop(next(iter(self._indices)))
            self._indices[key] = build_corpus_index(
                corpus, w, kind=self.name, bsp=self.bsp)
        return self._indices[key]

    def knn(self, queries, corpus, *, impl: str = "auto", seed_k: int = 2,
            return_stats: bool = False):
        """Exact 1-NN of each query against ``corpus`` via the cascade.
        Returns (nn_idx, nn_dist[, stats])."""
        from repro_torch.kernels import ops
        index = self.build_index(corpus)
        return ops._knn_cascade(self._t(queries), index, impl=impl,
                                seed_k=seed_k, return_stats=return_stats)


def make_measure(name: str, T: int, *,
                 sp: Optional[SparsePaths] = None,
                 radius: int = 10, nu: float = 1.0,
                 lags: int = 10, device=None) -> Measure:
    """Factory. ``T`` is the series length (for visited-cell accounting);
    ``device`` as for ``fit``."""
    return Measure(name, T, sp=sp, radius=radius, nu=nu, lags=lags,
                   device=device)


ALL_MEASURES = ("corr", "daco", "euclidean", "dtw", "dtw_sc",
                "krdtw", "spdtw", "sp_krdtw")
