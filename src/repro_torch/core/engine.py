"""Fitted-engine API: ``MeasureSpec -> fit(corpus) -> SimilarityEngine``.

The counterpart of ``repro.core.engine``: ``fit(spec, corpus)`` resolves
the support grid, the block-sparse tile plan and the per-corpus search
index exactly once, and returns a frozen ``SimilarityEngine`` whose
``pairs`` / ``gram`` / ``gram_log`` / ``knn`` / ``classify`` reuse them.
Every family of ``MeasureSpec`` fits: the min-plus DPs (``dtw``,
``dtw_sc``, ``spdtw``), the K_rdtw kernels (``krdtw``, ``krdtw_sc``,
``sp_krdtw``; log-kernel values, negated into dissimilarities by
``pairs`` / ``gram``) and the baselines (``euclidean``, ``corr``,
``daco``). ``dtw`` / ``spdtw`` engines carry the min-plus cascade's
index, univariate ``krdtw`` / ``sp_krdtw`` engines the log-semiring
cascade's (unit weights over the support, a plan for them, ``nu``);
the others find neighbours by the exact Gram argmin. Series may be
univariate (N, T) or multivariate (N, T, d) (the kernel families are
univariate on the card).

Every engine has a device. ``fit`` puts it on ``cuda`` unless the caller
passes ``device="cpu"``, and raises when asked for CUDA on a machine
without it: it never falls back to the CPU. The engine's methods move
their inputs to its device, so a CUDA engine runs the CUDA kernels and a
CPU engine the plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .dtw import band_mask
from .measures import CorpusIndex, build_corpus_index
from .occupancy import BlockSparsePaths, SparsePaths, learn_sparse_paths
from .spec import KERNEL_FAMILIES, MeasureSpec

_CASCADE_FAMILIES = ("dtw", "spdtw")   # admissible min-plus bounds exist
_BASELINES = ("euclidean", "corr", "daco")


def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on: ``cuda`` unless the caller
    names another; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to compute on the CPU")
    return dev


def _as_series(X, device) -> torch.Tensor:
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.array(X, np.float32))
    return X.to(device=device, dtype=torch.float32)


def _band_sp(T: int, radius: int, device) -> SparsePaths:
    """A Sakoe-Chiba corridor wrapped as a SparsePaths (unit weights)."""
    sup = band_mask(T, T, radius, device=device)
    return SparsePaths(weights=sup.to(torch.float32), support=sup,
                       counts=torch.zeros((T, T), device=device),
                       theta=0.0, gamma=0.0)


def _weights_sp(weights, device) -> SparsePaths:
    """A raw (T, T) weight grid wrapped as a SparsePaths."""
    w = _as_series(weights, device)
    return SparsePaths(weights=w, support=w > 0,
                       counts=torch.zeros_like(w), theta=0.0, gamma=0.0)


@dataclasses.dataclass(frozen=True)
class SimilarityEngine:
    """A measure fitted to (optionally) a corpus.

    spec            the ``MeasureSpec`` this engine realizes;
    T, d            series length / channel count;
    sp              the resolved ``SparsePaths`` support (None for the
                    dense-support families);
    weights         the dense (T, T) weight grid (None likewise);
    bsp             the block-sparse tile plan (dtw / spdtw only);
    corpus, labels  the fitted candidate set (None when fit
                    support-only);
    index           the per-corpus ``CorpusIndex`` of the min-plus or
                    the kernel cascade (None for the other families);
    device          where the engine's tensors live and compute;
    version         refresh stamp: 0 for a fresh ``fit``, bumped by
                    ``with_corpus``.

    Methods accept ``impl`` = "auto" | "cuda" | "scan" | "dense", resolved
    by ``kernels.backends.resolve`` against the engine's device.
    """
    spec: MeasureSpec
    T: int
    d: int = 1
    sp: Optional[SparsePaths] = None
    weights: Optional[torch.Tensor] = None
    bsp: Optional[BlockSparsePaths] = None
    corpus: Optional[torch.Tensor] = None
    labels: Optional[np.ndarray] = None
    index: Optional[CorpusIndex] = None
    device: torch.device = torch.device("cpu")
    version: int = 0

    @property
    def family(self) -> str:
        """The measure family this engine evaluates."""
        return self.spec.family

    @property
    def is_kernel(self) -> bool:
        """True for similarity (log-kernel) families."""
        return self.spec.is_kernel

    @property
    def corpus_size(self) -> int:
        """Number of fitted corpus series (0 when support-only)."""
        return 0 if self.corpus is None else int(self.corpus.shape[0])

    def _series(self, X) -> torch.Tensor:
        return _as_series(X, self.device)

    def _corpus_or(self, B) -> torch.Tensor:
        if B is not None:
            return self._series(B)
        if self.corpus is None:
            raise ValueError("engine was fit without a corpus; pass B")
        return self.corpus

    def _kernel_args(self) -> dict:
        """support / radius of a kernel family's DP domain."""
        f = self.family
        return {"support": self.sp.support
                if (f == "sp_krdtw" and self.sp is not None) else None,
                "radius": self.spec.radius if f == "krdtw_sc" else None}

    def pairs(self, x, y, *, impl: str = "auto") -> torch.Tensor:
        """Batched aligned-pair dissimilarity: (B, T[, d]) x same -> (B,).
        Kernel families return the negated log kernel, so every family
        is argmin-ready."""
        from repro_torch.kernels import ops
        x, y = self._series(x), self._series(y)
        f = self.family
        if f == "dtw":
            return ops._dtw_pairs(x, y, impl=impl)
        if f == "dtw_sc":
            return ops._dtw_pairs(x, y, impl=impl, radius=self.spec.radius)
        if f == "spdtw":
            return ops._spdtw_pairs(x, y, self.sp, bsp=self.bsp, impl=impl)
        if f in KERNEL_FAMILIES:
            return -ops._log_krdtw_pairs(x, y, self.spec.nu, impl=impl,
                                         **self._kernel_args())
        return ops._baseline_pairs(f, x, y, self.spec.lags)

    def gram(self, A, B=None, *, impl: str = "auto", block_a: int = 64,
             thresholds=None, alive0=None) -> torch.Tensor:
        """(Na, Nb) dissimilarity matrix against ``B`` (default: the
        fitted corpus) through the Gram engines; kernel families are
        negated into dissimilarities. ``thresholds``/``alive0`` engage
        the early-abandon sweep (spdtw only)."""
        from repro_torch.kernels import ops
        A = self._series(A)
        B = self._corpus_or(B)
        f = self.family
        if f != "spdtw" and (thresholds is not None or alive0 is not None):
            raise ValueError("early abandon needs the spdtw plan path")
        if f == "dtw":
            return ops._dtw_gram(A, B, impl=impl)
        if f == "spdtw":
            return ops._spdtw_gram(A, B, sp=self.sp, bsp=self.bsp,
                                   impl=impl, block_a=block_a,
                                   thresholds=thresholds, alive0=alive0)
        if f == "dtw_sc":
            return ops._dtw_sc_gram(A, B, self.spec.radius, impl=impl)
        if f in KERNEL_FAMILIES:
            return -self.gram_log(A, B, impl=impl)
        return ops._baseline_gram(f, A, B, self.spec.lags, block=block_a)

    def gram_log(self, A, B=None, *, impl: str = "auto") -> torch.Tensor:
        """(Na, Nb) log-kernel Gram matrix (kernel families only; the SVM
        workload's input): K3 on the card."""
        from repro_torch.kernels import ops
        if not self.is_kernel:
            raise ValueError(f"{self.family} is not a kernel")
        A = self._series(A)
        B = self._corpus_or(B)
        return ops._log_krdtw_gram(A, B, self.spec.nu, impl=impl,
                                   **self._kernel_args())

    def knn(self, Q, *, impl: str = "auto", seed_k: int = 2,
            prefix_frac: float = 0.5, return_stats: bool = False,
            mode: str = "exact"):
        """Exact 1-NN of each query against the fitted corpus:
        dissimilarity engines through the lower-bound cascade (DESIGN.md
        §4), kernel engines through the log-semiring cascade (§14), both
        bit-identical to the full Gram argmin; families without an index
        (dtw_sc, krdtw_sc, the baselines, multivariate kernels) take the
        Gram argmin itself. Returns (nn_idx, nn_dist[, stats])."""
        from repro_torch.kernels import ops
        if mode != "exact":
            raise NotImplementedError("only mode='exact' is ported; the "
                                      "sketch tier comes later")
        if self.corpus is None:
            raise ValueError("engine was fit without a corpus")
        Q = self._series(Q)
        if self.index is not None:
            cascade = ops._krdtw_knn_cascade \
                if self.index.kind in ("krdtw", "sp_krdtw") \
                else ops._knn_cascade
            return cascade(Q, self.index, impl=impl, seed_k=seed_k,
                           prefix_frac=prefix_frac,
                           return_stats=return_stats)
        D = self.gram(Q, impl=impl)
        nn = torch.argmin(D, dim=1).to(torch.int32)
        nnd = D.gather(1, nn[:, None].long())[:, 0]
        if not return_stats:
            return nn, nnd
        return nn, nnd, {"n_queries": int(Q.shape[0]),
                         "n_candidates": self.corpus_size,
                         "pre_dp_prune": 0.0,
                         "dp_pairs": int(Q.shape[0]) * self.corpus_size}

    def classify(self, Q, *, impl: str = "auto",
                 via: str = "auto") -> np.ndarray:
        """Predicted labels for queries ``Q``: 1-NN over the corpus
        labels."""
        if via not in ("auto", "knn"):
            raise NotImplementedError("nearest-centroid classification is "
                                      "not ported yet")
        if self.labels is None:
            raise ValueError("engine was fit without labels")
        nn, _ = self.knn(Q, impl=impl)
        return np.asarray(self.labels)[nn.cpu().numpy()]

    def with_corpus(self, corpus, labels=None) -> "SimilarityEngine":
        """Re-fit the corpus-dependent artifacts (index) on a new candidate
        set, reusing the resolved support and plan; the successor carries
        ``version + 1``."""
        eng = fit(self.spec, corpus, labels=labels, sp=self.sp,
                  bsp=self.bsp, T=self.T, device=self.device)
        return dataclasses.replace(eng, version=self.version + 1)


def fit(spec: MeasureSpec, corpus=None, *, labels=None,
        sp: Optional[SparsePaths] = None, weights=None,
        bsp: Optional[BlockSparsePaths] = None, support_corpus=None,
        n_support: Optional[int] = None, T: Optional[int] = None,
        device=None) -> SimilarityEngine:
    """Fit a ``MeasureSpec`` to data: resolve support, plan and index once.

    corpus:          (N, T) or (N, T, d) candidate set; optional (a
                     support-only engine still evaluates pairs/gram).
    labels:          (N,) class labels riding with the corpus.
    sp / weights /
    bsp:             pre-resolved support handles, used instead of
                     learning.
    support_corpus:  series to learn the occupancy prior from (default:
                     the corpus; ``n_support`` caps how many are used).
    T:               series length for support-only engines.
    device:          where to compute; default ``cuda`` (raises without
                     it). Pass ``"cpu"`` for the plain versions.
    """
    from repro_torch.kernels import backends as bk
    dev = resolve_device(device)
    if corpus is not None:
        corpus = _as_series(corpus, dev)
        T = int(corpus.shape[1])
        d = bk.series_dim(corpus)
    else:
        d = 1
    if not spec.is_sparse:
        sp = weights = bsp = None
    if sp is None and weights is not None:
        sp = _weights_sp(weights, dev)
    if spec.is_sparse and sp is None and bsp is None:
        if spec.support == "learned":
            src = support_corpus if support_corpus is not None else corpus
            if src is None:
                raise ValueError("learned support needs a corpus (or pass "
                                 "sp/weights)")
            src = _as_series(src, dev)
            if n_support is not None:
                src = src[:n_support]
            sp = learn_sparse_paths(src, theta=spec.theta,
                                    gamma=spec.weight_gamma)
            T = int(src.shape[1]) if T is None else T
        else:
            if T is None:
                raise ValueError("band support needs a corpus or T")
            sp = _band_sp(T, spec.radius, dev)
    if T is None:
        T = sp.weights.shape[0] if sp is not None else \
            (bsp.T if bsp is not None else None)
    if T is None:
        raise ValueError("could not infer the series length; pass corpus "
                         "or T")
    w = None if sp is None else sp.weights.to(dev)
    # only the min-plus families execute on the block plan; the kernel
    # and baseline engines dispatch on support / radius
    plan = None
    if spec.family in _CASCADE_FAMILIES:
        if bsp is not None:
            plan = bsp
        elif w is not None:
            plan = bk.resolve_plan(weights=w, tile=spec.tile)
        else:
            plan = bk.resolve_plan(T=T, tile=spec.tile)
    index = None
    if corpus is not None and spec.family in _CASCADE_FAMILIES:
        if w is None and spec.is_sparse:
            # bsp-only fit: reassemble the grid so the cascade's bounds
            # see the real weights
            sp = _weights_sp(bk.densify(plan)[:T, :T], dev)
            w = sp.weights
        iw = w if w is not None else np.ones((T, T), np.float32)
        index = build_corpus_index(corpus, iw, kind=spec.family, bsp=plan)
    elif corpus is not None and d == 1 and \
            spec.family in ("krdtw", "sp_krdtw"):
        # kernel-measure index (DESIGN.md §14): unit weights over the
        # support, a plan for them, and nu; build_corpus_index computes
        # the K1/K2 slacks from the same support
        if spec.family == "sp_krdtw":
            if sp is None:
                raise ValueError("sp_krdtw fit did not resolve a support")
            sup_w = sp.support.detach().cpu().numpy().astype(np.float32)
        else:
            sup_w = np.ones((T, T), np.float32)
        index = build_corpus_index(
            corpus, sup_w, kind=spec.family,
            bsp=bk.resolve_plan(weights=sup_w, tile=spec.tile), nu=spec.nu)
    return SimilarityEngine(
        spec=spec, T=T, d=d, sp=sp, weights=w, bsp=plan, corpus=corpus,
        labels=None if labels is None else np.asarray(labels),
        index=index, device=dev)
