"""Fitted-engine API: ``MeasureSpec -> fit(corpus) -> SimilarityEngine``.

The counterpart of ``repro.core.engine``: ``fit(spec, corpus)`` resolves
the support grid, the block-sparse tile plan and the per-corpus search
index exactly once, and returns a frozen ``SimilarityEngine`` whose
``pairs`` / ``gram`` / ``gram_log`` / ``knn`` / ``classify`` and the
differentiable ``soft_pairs`` / ``soft_gram`` / ``grad`` / ``barycenter``
/ ``fit_centroids`` reuse them; ``measure`` is its ``Measure`` view
(paper Table VI's visited cells). A spec with ``sketch_r > 0`` also
fits the Random Warping Series sketch (``core.sketch``):
``knn(mode="sketch")`` and ``sketch_embed``.
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
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from .dtw import band_mask
from .measures import (CorpusIndex, Measure, _as_series, build_corpus_index,
                       make_measure)
from .occupancy import (BlockSparsePaths, SparsePaths, learn_sparse_paths,
                        pairwise_path_counts)
from .spec import KERNEL_FAMILIES, MeasureSpec

_CASCADE_FAMILIES = ("dtw", "spdtw")   # admissible min-plus bounds exist
_SOFT_FAMILIES = ("dtw", "spdtw")      # min-plus DPs with a soft twin
_BASELINES = ("euclidean", "corr", "daco")


def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on: ``cuda`` unless the caller
    names another; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to compute on the CPU")
    return dev


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
                    ``with_corpus``;
    centroid_model  fitted ``cluster.CentroidModel`` (optional): the
                    cascade seeds from it and ``classify`` serves
                    nearest-centroid.

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
    centroid_model: Optional[object] = None

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

    @property
    def measure(self) -> Measure:
        """The ``core.measures.Measure`` view of this engine (pair-level
        evaluators, visited-cell accounting), on the engine's device."""
        return make_measure(self.family, self.T, sp=self.sp,
                            radius=self.spec.radius, nu=self.spec.nu,
                            lags=self.spec.lags, device=self.device)

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
        with trace.span("pairs"):
            x, y = self._series(x), self._series(y)
            f = self.family
            if f == "dtw":
                return ops._dtw_pairs(x, y, impl=impl)
            if f == "dtw_sc":
                return ops._dtw_pairs(x, y, impl=impl,
                                      radius=self.spec.radius)
            if f == "spdtw":
                return ops._spdtw_pairs(x, y, self.sp, bsp=self.bsp,
                                        impl=impl)
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
        with trace.span("gram_log"):
            A = self._series(A)
            B = self._corpus_or(B)
            return ops._log_krdtw_gram(A, B, self.spec.nu, impl=impl,
                                       **self._kernel_args())

    def knn(self, Q, *, impl: str = "auto", seed_k: int = 2,
            prefix_frac: float = 0.5, return_stats: bool = False,
            mode: str = "exact", top_c: Optional[int] = None,
            approx: bool = False):
        """1-NN of each query against the fitted corpus.

        ``mode="exact"``: dissimilarity engines through the lower-bound
        cascade (DESIGN.md §4), kernel engines through the log-semiring
        cascade (§14), both bit-identical to the full Gram argmin;
        families without an index (dtw_sc, krdtw_sc, the baselines,
        multivariate kernels) take the Gram argmin itself.

        ``mode="sketch"`` (DESIGN.md §13; needs a spec fit with
        ``sketch_r > 0``): the sketch matmul shortlist of the ``top_c``
        sketch-nearest candidates, re-ranked exactly (K2 on the card):
        equal to exact mode whenever the shortlist holds the true
        neighbour; ``approx=True`` skips the re-rank.
        Returns (nn_idx, nn_dist[, stats]). In exact mode
        ``return_stats="counts"`` returns the cascade's pair counts in
        place of the stats, without a host read
        (``kernels.ops._cascade_counts``; ``ops.cascade_stats`` turns them
        into the stats)."""
        from repro_torch.kernels import ops
        if mode not in ("exact", "sketch"):
            raise ValueError(f"mode must be exact or sketch, not {mode!r}")
        if self.corpus is None:
            raise ValueError("engine was fit without a corpus")
        Q = self._series(Q)
        if mode == "sketch":
            from .sketch import sketch_knn
            if self.index is None or self.index.sketch is None:
                raise ValueError("sketch mode needs a spec fit with "
                                 "sketch_r > 0")
            return sketch_knn(Q, self.index, top_c=top_c, approx=approx,
                              impl=impl, return_stats=return_stats)
        if self.index is not None:
            kw = dict(impl=impl, seed_k=seed_k, prefix_frac=prefix_frac,
                      return_stats=return_stats)
            if self.index.kind in ("krdtw", "sp_krdtw"):
                return ops._krdtw_knn_cascade(Q, self.index, **kw)
            return ops._knn_cascade(Q, self.index,
                                    centroid_model=self.centroid_model, **kw)
        D = self.gram(Q, impl=impl)
        nn = torch.argmin(D, dim=1).to(torch.int32)
        nnd = D.gather(1, nn[:, None].long())[:, 0]
        if not return_stats:
            return nn, nnd
        pairs = int(Q.shape[0]) * self.corpus_size
        if return_stats == "counts":
            return nn, nnd, {"pairs": pairs, "seed_pairs": 0,
                             "dp_pairs": pairs, "abandoned": 0,
                             "stage1_pruned": 0, "stage2_pruned": 0,
                             "stage3_pruned": 0}
        return nn, nnd, {"n_queries": int(Q.shape[0]),
                         "n_candidates": self.corpus_size,
                         "pre_dp_prune": 0.0, "dp_pairs": pairs}

    def sketch_embed(self, X, *, impl: str = "auto") -> torch.Tensor:
        """Project series into the engine's (R,) sketch space:
        (B, T) -> (B, R), one masked DP per (series, anchor) pair under
        the fitted support and weights (K1 on the card; K7 for a soft
        sketch): the features ``mode="sketch"`` shortlists on. Needs a
        spec fit with ``sketch_r > 0``."""
        from .sketch import sketch_embed as _sketch_embed
        if self.index is None or self.index.sketch is None:
            raise ValueError("sketch_embed needs a spec fit with "
                             "sketch_r > 0")
        si = self.index.sketch
        return _sketch_embed(self._series(X), si.anchors,
                             bsp=self.index.bsp, weights=self.index.weights,
                             gamma=si.gamma, impl=impl)

    def classify(self, Q, *, impl: str = "auto",
                 via: str = "auto") -> np.ndarray:
        """Predicted labels for queries ``Q``: nearest-centroid when a
        centroid model was fit (``via="centroid"`` forces it, "knn" forces
        the cascade / Gram path), else 1-NN over the corpus labels."""
        if via not in ("auto", "knn", "centroid"):
            raise ValueError(f"via must be auto, knn or centroid, not "
                             f"{via!r}")
        if via == "centroid" or (via == "auto" and
                                 self.centroid_model is not None):
            if self.centroid_model is None:
                raise ValueError("no centroid model fit")
            from repro_torch.classify.centroid import \
                nearest_centroid_predict
            return nearest_centroid_predict(
                self._series(Q), self.centroid_model,
                impl=impl).cpu().numpy()
        if self.labels is None:
            raise ValueError("engine was fit without labels")
        nn, _ = self.knn(Q, impl=impl)
        return np.asarray(self.labels)[nn.cpu().numpy()]

    # ---- differentiable layer ------------------------------------------
    def _soft_weights(self) -> torch.Tensor:
        if self.family not in _SOFT_FAMILIES:
            raise ValueError(f"{self.family} has no soft (differentiable) "
                             f"twin")
        if self.weights is not None:
            return self.weights
        return torch.ones((self.T, self.T), dtype=torch.float32,
                          device=self.device)

    def soft_pairs(self, x, y) -> torch.Tensor:
        """Differentiable aligned-pair soft measure at the spec's
        ``gamma``: K8 / K9 under grad, K7 otherwise (on the card)."""
        from repro_torch.kernels.soft_block import soft_spdtw_batch
        return soft_spdtw_batch(self._series(x), self._series(y),
                                self._soft_weights(), float(self.spec.gamma),
                                bsp=self.bsp)

    def soft_gram(self, A, B=None) -> torch.Tensor:
        """Differentiable all-pairs soft Gram matrix against ``B``
        (default: the corpus) at the spec's ``gamma``: K8 / K9 under
        grad, K7 otherwise (on the card)."""
        from repro_torch.kernels.soft_block import soft_spdtw_gram_batch
        return soft_spdtw_gram_batch(self._series(A), self._corpus_or(B),
                                     self._soft_weights(),
                                     float(self.spec.gamma), bsp=self.bsp)

    def grad(self, x, y):
        """(values, d values / d x) of the soft measure for aligned
        pairs; the gradient never leaves the learned support."""
        x = self._series(x).detach().requires_grad_()
        y = self._series(y)
        with torch.enable_grad():
            val = self.soft_pairs(x, y)
            (gx,) = torch.autograd.grad(val.sum(), x)
        return val.detach(), gx

    def barycenter(self, X=None, *, sample_weights=None, init=None,
                   steps: int = 100, lr: float = 0.05):
        """Fit one soft barycenter over ``X`` (default: the corpus) under
        the engine's support and ``gamma``. Returns (centroid (T[, d]),
        per-step loss history)."""
        from repro_torch.cluster.barycenter import soft_barycenter
        return soft_barycenter(self._corpus_or(X), self._soft_weights(),
                               float(self.spec.gamma), init=init,
                               steps=steps, lr=lr,
                               sample_weights=sample_weights, bsp=self.bsp)

    def fit_centroids(self, n_per_class: int = 1, *, steps: int = 60,
                      lr: float = 0.05, impl: str = "auto",
                      seed: Optional[int] = None) -> "SimilarityEngine":
        """Fit ``n_per_class`` soft-barycenter centroids per class label
        on the corpus and return a new engine carrying the model (the
        cascade seeds from it; ``classify`` serves nearest-centroid).
        ``seed`` defaults to the spec's."""
        if self.corpus is None or self.labels is None:
            raise ValueError("centroid fitting needs a corpus with labels")
        from repro_torch.cluster import fit_class_centroids
        model = fit_class_centroids(
            self.corpus, self.labels, self._soft_weights(),
            float(self.spec.gamma), n_per_class=n_per_class, steps=steps,
            lr=lr, impl=impl,
            seed=self.spec.seed if seed is None else seed, bsp=self.bsp)
        return dataclasses.replace(self, centroid_model=model)

    def with_corpus(self, corpus, labels=None) -> "SimilarityEngine":
        """Re-fit the corpus-dependent artifacts (index) on a new candidate
        set, reusing the resolved support and plan; the successor carries
        ``version + 1``."""
        eng = fit(self.spec, corpus, labels=labels, sp=self.sp,
                  bsp=self.bsp, T=self.T, device=self.device)
        return dataclasses.replace(eng, version=self.version + 1)

    def shard(self, n_shards: int) -> Tuple["SimilarityEngine", ...]:
        """Partition the fitted corpus state into contiguous row shards.

        Returns ``n_shards`` engines (clamped to the corpus size), shard s
        holding global rows ``[offsets[s], offsets[s+1])`` with
        ``np.array_split`` sizes (they differ by at most one), its labels
        and its index rows (``CorpusIndex.take``); the support, weights
        and plan are shared by reference, and every shard keeps this
        engine's device. Slicing, not re-fitting: each shard engine's
        index equals ``with_corpus(shard)``'s bit for bit."""
        if self.corpus is None:
            raise ValueError("shard() needs a fitted corpus")
        n = self.corpus_size
        out = []
        for ids in np.array_split(np.arange(n), max(1, min(int(n_shards),
                                                           n))):
            sel = slice(int(ids[0]), int(ids[-1]) + 1)
            out.append(dataclasses.replace(
                self, corpus=self.corpus[sel],
                labels=None if self.labels is None else self.labels[sel],
                index=None if self.index is None else self.index.take(sel)))
        return tuple(out)


def fit(spec: MeasureSpec, corpus=None, *, labels=None,
        sp: Optional[SparsePaths] = None, weights=None,
        bsp: Optional[BlockSparsePaths] = None, support_corpus=None,
        n_support: Optional[int] = None, T: Optional[int] = None,
        device=None, centroids: int = 0,
        centroid_steps: int = 60) -> SimilarityEngine:
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
    centroids:       fit this many soft-barycenter centroids per class
                     at fit time (> 0 needs labels), ``centroid_steps``
                     Adam steps each.

    With the recorder of ``repro_torch.trace`` on, ``fit`` records the
    span ``fit`` and its phases ``fit.counts`` (the occupancy counts),
    ``fit.support`` (normalise and threshold), ``fit.plan`` (the tile
    plan) and ``fit.index`` (the corpus index). ``fit`` is set-up, so
    these spans wait for the device at their end (only while the recorder
    is on): each holds its phase's device work.
    """
    from repro_torch.kernels import backends as bk
    dev = resolve_device(device)
    with trace.span("fit", sync=dev):
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
                with trace.span("fit.counts", sync=dev):
                    counts = pairwise_path_counts(src)
                with trace.span("fit.support", sync=dev):
                    sp = learn_sparse_paths(src, theta=spec.theta,
                                            gamma=spec.weight_gamma,
                                            counts=counts)
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
            with trace.span("fit.plan", sync=dev):
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
            with trace.span("fit.index", sync=dev):
                index = build_corpus_index(corpus, iw, kind=spec.family,
                                           bsp=plan)
                if spec.sketch_r > 0 and d == 1:
                    # sketch tier (DESIGN.md §13): anchors drawn on the CPU
                    # from the spec's seed, corpus embedded through the same
                    # engines
                    from .sketch import (anchor_generator, build_sketch_index,
                                         random_anchors)
                    anchors = random_anchors(anchor_generator(spec.seed),
                                             spec.sketch_r, T,
                                             max_len=spec.sketch_len).to(dev)
                    si = build_sketch_index(corpus, anchors, bsp=index.bsp,
                                            weights=index.weights,
                                            seed=spec.seed)
                    index = dataclasses.replace(index, sketch=si)
        elif corpus is not None and d == 1 and \
                spec.family in ("krdtw", "sp_krdtw"):
            # kernel-measure index (DESIGN.md §14): unit weights over the
            # support, a plan for them, and nu; build_corpus_index computes
            # the K1/K2 slacks from the same support
            if spec.family == "sp_krdtw" and sp is None:
                raise ValueError("sp_krdtw fit did not resolve a support")
            with trace.span("fit.plan", sync=dev):
                if spec.family == "sp_krdtw":
                    sup_w = sp.support.detach().cpu().numpy() \
                        .astype(np.float32)
                else:
                    sup_w = np.ones((T, T), np.float32)
                kplan = bk.resolve_plan(weights=sup_w, tile=spec.tile)
            with trace.span("fit.index", sync=dev):
                index = build_corpus_index(corpus, sup_w, kind=spec.family,
                                           bsp=kplan, nu=spec.nu)
        engine = SimilarityEngine(
            spec=spec, T=T, d=d, sp=sp, weights=w, bsp=plan, corpus=corpus,
            labels=None if labels is None else np.asarray(labels),
            index=index, device=dev)
        if centroids > 0:
            engine = engine.fit_centroids(centroids, steps=centroid_steps)
        return engine


def engine_for(family: str = "spdtw", *, sp=None, bsp=None, weights=None,
               tile=None, gamma: float = 0.1, nu: float = 1.0,
               radius: int = 10, T: Optional[int] = None,
               device=None) -> SimilarityEngine:
    """Support-only engine from whichever handles the caller holds (the
    jobs of ``launch/gram.py`` and ``launch/cluster.py`` fit through it):
    the dense-support families take the dense support, the others the
    "learned" one resolved from ``sp`` / ``weights`` / ``bsp``. ``device``
    as for ``fit``."""
    support = "dense" if family in ("dtw", "krdtw", "euclidean", "corr",
                                    "daco", "dtw_sc", "krdtw_sc") \
        else "learned"
    spec = MeasureSpec(family=family, support=support, gamma=gamma, nu=nu,
                       radius=radius, tile=tile)
    return fit(spec, sp=sp, weights=weights, bsp=bsp, T=T, device=device)
