"""Plain kernel SVM on precomputed, cosine-normalised Grams (paper Table
IV): the bias-free dual

    max_a 1^T a - 1/2 a^T Q a,  Q = (y y^T) o K,  0 <= a <= C

of each one-vs-rest problem, solved by projected gradient ascent with the
step 1 / (largest row sum of |Q|); C chosen by 3-fold cross-validation
(folds from ``default_rng(0)``'s permutation, the first C of least mean
fold error), as the paper's protocol does. Plain PyTorch; nothing of the
program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

C_GRID = (0.1, 1.0, 10.0, 100.0)
FOLDS = 3
ITERS = 500


def normalized(logk_xy, logk_xx, logk_yy):
    """K(x, y) / sqrt(K(x, x) K(y, y)) from log kernels."""
    return torch.exp(logk_xy - 0.5 * (logk_xx[:, None] + logk_yy[None, :]))


def one_vs_rest(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(k, n) labels in {-1, +1}, one row per class."""
    k = torch.arange(n_classes, device=y.device)[:, None]
    return torch.where(y[None, :] == k, 1.0, -1.0).to(torch.float32)


def fit(K: torch.Tensor, y: torch.Tensor, n_classes: int, C: float,
        iters: int = ITERS) -> torch.Tensor:
    """(k, n) dual coefficients of the one-vs-rest problems."""
    yb = one_vs_rest(y, n_classes)
    a = torch.zeros(yb.shape, dtype=torch.float32, device=K.device)
    for c in range(n_classes):
        Qc = K * (yb[c][:, None] * yb[c][None, :])
        step = 1.0 / max(float(Qc.abs().sum(dim=1).max()), 1e-6)
        ac = a[c]
        for _ in range(iters):
            ac = torch.clamp(ac + step * (1.0 - Qc @ ac), 0.0, C)
        a[c] = ac
    return a


def decisions(alphas: torch.Tensor, K_test: torch.Tensor, y: torch.Tensor,
              n_classes: int) -> torch.Tensor:
    """(n_test, k) decision values sum_i a_ki y_ki K(x_i, x)."""
    return K_test @ (alphas * one_vs_rest(y, n_classes)).T


def select_c(K: torch.Tensor, y: torch.Tensor, n_classes: int) -> float:
    """The C of ``C_GRID`` with the least mean 3-fold error on the train
    Gram, the first on ties."""
    n = K.shape[0]
    folds = np.array_split(np.random.default_rng(0).permutation(n), FOLDS)
    best, best_err = None, None
    for C in C_GRID:
        errs = []
        for f in range(FOLDS):
            va = torch.as_tensor(folds[f], device=K.device)
            tr = torch.as_tensor(np.concatenate(
                [folds[g] for g in range(FOLDS) if g != f]), device=K.device)
            k_cv = int(y.max()) + 1
            al = fit(K[tr][:, tr], y[tr], k_cv, C)
            pred = decisions(al, K[va][:, tr], y[tr], k_cv).argmax(dim=1)
            errs.append(float((pred != y[va]).to(torch.float32).mean()))
        err = float(np.mean(errs))
        if best_err is None or err < best_err:
            best, best_err = C, err
    return best
