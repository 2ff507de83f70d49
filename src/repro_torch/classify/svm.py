"""Kernel SVM on precomputed Gram matrices (paper Table IV).

The counterpart of ``repro.classify.svm``. The (bias-free) dual

    max_a  1^T a - 1/2 a^T Q a ,  Q = (y y^T) o K ,  0 <= a <= C

is solved by projected gradient ascent, deterministically, for all the
one-vs-rest problems at once: the alphas of k classes are one (k, n)
tensor and each step is one batched matrix-vector product. Dropping the
bias removes the equality constraint; with cosine-normalized kernels
(K(x, x) = 1) this is the standard "SVM without offset".

``svm_gram_series`` builds the two normalized Gram blocks straight from
raw series through the fitted engine: ``engine.gram_log`` (K3 on the
card) for the train x train and test x train log-kernel Grams, and
``engine.pairs`` (K4) for the test self-similarities.
``svm_rws_series`` builds linear Gram blocks from the engine's sketch
features instead (K1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import trace

# svm_predict forms its (test, class, train) products this many at a time
_PREDICT_CHUNK = 1 << 24


def _solve_binary(K: torch.Tensor, ybins: torch.Tensor, C: float,
                  iters: int = 500) -> torch.Tensor:
    """Projected gradient ascent on the bias-free dual of each row of
    ``ybins`` ((k, n) labels in {-1, +1}). Returns (k, n) alphas."""
    Q = K[None] * (ybins[:, :, None] * ybins[:, None, :])     # (k, n, n)
    # Lipschitz bound of each gradient: the largest row sum of |Q|
    L = torch.clamp_min(Q.abs().sum(dim=2).amax(dim=1), 1e-6)
    step = (1.0 / L)[:, None]
    a = torch.zeros(ybins.shape, dtype=K.dtype, device=K.device)
    for _ in range(iters):
        g = 1.0 - torch.bmm(Q, a[:, :, None])[:, :, 0]
        a = torch.clamp(a + step * g, 0.0, C)
    return a


def _ybins(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    k = torch.arange(n_classes, device=y.device)[:, None]
    return torch.where(y[None, :] == k, 1.0, -1.0).to(torch.float32)


def _labels(y, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(y) if not isinstance(y, torch.Tensor)
                           else y, device=device)


def svm_fit(K: torch.Tensor, y, n_classes: int, C: float,
            iters: int = 500) -> torch.Tensor:
    """One-vs-rest alphas, shape (n_classes, n_train)."""
    return _solve_binary(K, _ybins(_labels(y, K.device), n_classes), C,
                         iters)


def svm_predict(alphas: torch.Tensor, K_test: torch.Tensor, y,
                n_classes: int) -> torch.Tensor:
    """K_test: (N_test, N_train). Returns predicted labels (argmax of the
    decision values, first index on ties). Products below float32's
    normal range count as zero, as in the reference's XLA
    (``core.krdtw.flush_subnormal``)."""
    from repro_torch.core.krdtw import flush_subnormal
    with trace.span("svm_predict"):
        ybins = _ybins(_labels(y, K_test.device), n_classes)
        # decision_k(x) = sum_i a_ki ybin_ki K(x_i, x), test rows in blocks
        coef = (alphas * ybins)[None, :, :]
        rows = max(1, _PREDICT_CHUNK // max(1, coef.numel()))
        dec = torch.cat([flush_subnormal(coef * K_test[s:s + rows, None, :])
                         .sum(dim=2)
                         for s in range(0, K_test.shape[0], rows)])
        return torch.argmax(dec, dim=1)


def svm_gram_series(X_train, X_test, *, kind: str = "sp_krdtw", sp=None,
                    nu: float = 1.0, radius: int = 10, impl: str = "auto",
                    device=None):
    """Cosine-normalized SVM Gram blocks straight from raw series.

    Fits a kernel engine for ``kind`` ("krdtw", "krdtw_sc" with
    ``radius``, or "sp_krdtw" on the learned ``sp``) and routes the two
    all-pairs log-kernel blocks through ``engine.gram_log``; the test-set
    self-similarities come from ``engine.pairs``. As in the reference,
    the krdtw_sc test rows are normalized by the full-grid K_rdtw
    self-similarity. ``device`` as for ``fit``. Returns (K_train, K_test)
    ready for ``svm_fit`` / ``svm_predict``.
    """
    from repro_torch.core.engine import fit
    from repro_torch.core.krdtw import normalized_gram
    from repro_torch.core.spec import MeasureSpec
    if kind == "sp_krdtw" and sp is None:
        raise ValueError("sp_krdtw needs the learned SparsePaths")
    T = int(np.shape(X_train)[1])
    support = "learned" if kind == "sp_krdtw" else "dense"
    eng = fit(MeasureSpec(kind, support=support, nu=nu, radius=radius),
              sp=sp, T=T, device=device)
    Xtr = eng._series(X_train)
    Xte = eng._series(X_test)
    lg_tt = eng.gram_log(Xtr, Xtr, impl=impl)
    lg_et = eng.gram_log(Xte, Xtr, impl=impl)
    d_tt = torch.diagonal(lg_tt)
    self_eng = eng if kind != "krdtw_sc" else \
        fit(MeasureSpec("krdtw", support="dense", nu=nu), T=T,
            device=eng.device)
    d_ee = -self_eng.pairs(Xte, Xte, impl=impl)
    return (normalized_gram(lg_tt, d_tt, d_tt),
            normalized_gram(lg_et, d_ee, d_tt))


def svm_rws_series(X_train, X_test, *, sp=None, R: int = 32,
                   seed: int = 0, theta: float = 1.0,
                   bandwidth: float = None, impl: str = "auto",
                   device=None):
    """Linear-SVM Gram blocks from Random Warping Series features, the
    sketch tier's classification path.

    Fits an SP-DTW engine with ``R`` sketch anchors (drawn from ``seed``
    through the spec, so the features are reproducible), embeds both
    splits as their SP-DTW distances to the anchors on the learned
    support (K1 on the card), and maps distances to RWS features
    ``exp(-d / (2 b^2)) / sqrt(R)`` (``bandwidth`` b defaults to the
    square root of the median train sketch distance). ``device`` as for
    ``fit``. Returns (K_train, K_test), plain feature inner products,
    ready for ``svm_fit`` / ``svm_predict``.
    """
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    spec = MeasureSpec("spdtw", theta=theta, seed=seed, sketch_r=R)
    eng = fit(spec, X_train, sp=sp, device=device)
    si = eng.index.sketch
    D_tr = si.sketch                                      # (N_tr, R)
    D_te = eng.sketch_embed(X_test, impl=impl)            # (N_te, R)
    if bandwidth is None:
        bandwidth = float(torch.sqrt(_median(D_tr) + 1e-8))
    scale = 2.0 * bandwidth * bandwidth
    root_r = torch.sqrt(torch.tensor(float(si.R), device=D_tr.device))
    F_tr = torch.exp(-D_tr / scale) / root_r
    F_te = torch.exp(-D_te / scale) / root_r
    return F_tr @ F_tr.T, F_te @ F_tr.T


def _median(X: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all entries: the mean of the two middle values
    for an even count (``torch.median`` takes the lower one)."""
    v = torch.sort(X.reshape(-1)).values
    n = v.shape[0]
    return v[n // 2] if n % 2 else (v[n // 2 - 1] + v[n // 2]) / 2


def svm_error(K_train: torch.Tensor, K_test: torch.Tensor, y_train, y_test,
              n_classes: int, C_grid=(0.1, 1.0, 10.0, 100.0), folds: int = 3,
              iters: int = 500, seed: int = 0) -> float:
    """Cross-validate C on train (``folds`` folds drawn by
    ``default_rng(seed)``, the first C of least mean fold error), then
    report the test error."""
    dev = K_train.device
    y_train = _labels(y_train, dev)
    y_test = _labels(y_test, dev)
    n = K_train.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    fold_ids = np.array_split(perm, folds)
    k_cv = int(y_train.max()) + 1

    def cv_err(C):
        errs = []
        for f in range(folds):
            va = torch.as_tensor(fold_ids[f], device=dev)
            tr = torch.as_tensor(np.concatenate(
                [fold_ids[g] for g in range(folds) if g != f]), device=dev)
            Ktr = K_train[tr][:, tr]
            Kva = K_train[va][:, tr]
            al = svm_fit(Ktr, y_train[tr], k_cv, C, iters)
            pred = svm_predict(al, Kva, y_train[tr], k_cv)
            errs.append(float((pred != y_train[va]).to(torch.float32)
                              .mean()))
        return float(np.mean(errs))

    best_C = min(C_grid, key=cv_err)
    al = svm_fit(K_train, y_train, n_classes, best_C, iters)
    pred = svm_predict(al, K_test, y_train, n_classes)
    return float((pred != y_test).to(torch.float32).mean())
