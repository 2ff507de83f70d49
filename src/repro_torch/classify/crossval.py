"""Meta-parameter selection (paper Section V-B, Fig. 4).

The counterpart of ``repro.classify.crossval``: theta (occupancy
threshold), gamma (weight exponent), the Sakoe-Chiba radius and nu
(local-kernel bandwidth) are picked by leave-one-out 1-NN error on the
train set over a grid, the paper's protocol. Each candidate is a fitted
engine's train x train Gram (``fit(MeasureSpec(...)).gram``: K6 for
dtw_sc, K3 for the kernel families, K1 for spdtw on the card). The
occupancy counts are computed once and shared by every theta candidate;
at equal LOO error the support with fewer cells wins. ``device`` is as
for ``fit``: ``cuda`` unless the caller names another.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.engine import _as_series, fit, resolve_device
from repro_torch.core.occupancy import (SparsePaths, learn_sparse_paths,
                                        pairwise_path_counts)
from repro_torch.core.spec import MeasureSpec
from .knn import loo_error

THETA_GRID = tuple(range(0, 16))             # paper Fig. 4 searches [0, 15]
GAMMA_GRID = (0.0, 0.25, 0.5, 1.0)
NU_GRID = (0.01, 0.1, 0.5, 1.0, 5.0)
RADIUS_FRACS = (0.0, 0.02, 0.05, 0.1, 0.2)   # of T


@dataclasses.dataclass
class Selected:
    theta: float = 0.0
    gamma: float = 0.0
    nu: float = 1.0
    radius: int = 0
    loo: float = 1.0
    sp: Optional[SparsePaths] = None


def _loo(spec: MeasureSpec, X_train, y_train, *, sp=None,
         device=None) -> float:
    eng = fit(spec, sp=sp, T=int(np.shape(X_train)[1]), device=device)
    X = eng._series(X_train)
    return loo_error(eng.gram(X, X), y_train)


def select_radius(X_train, y_train, fracs=RADIUS_FRACS, *,
                  device=None) -> Selected:
    """Sakoe-Chiba corridor width by LOO (the paper's DTW_sc protocol)."""
    T = int(np.shape(X_train)[1])
    best = Selected()
    for fr in fracs:
        r = max(int(round(fr * T)), 0)
        err = _loo(MeasureSpec("dtw_sc", support="band", radius=r),
                   X_train, y_train, device=device)
        if err < best.loo:
            best = Selected(radius=r, loo=err)
    return best


def select_nu(X_train, y_train, name: str = "krdtw", radius: int = 0,
              grid=NU_GRID, sp=None, *, device=None) -> Selected:
    """Pick the local-kernel bandwidth nu by leave-one-out 1-NN error on
    train (paper Sec. V-B); X_train: (N, T)."""
    best = Selected()
    support = "learned" if name == "sp_krdtw" else "dense"
    for nu in grid:
        err = _loo(MeasureSpec(name, support=support, nu=nu, radius=radius),
                   X_train, y_train, sp=sp, device=device)
        if err < best.loo:
            best = Selected(nu=nu, radius=radius, loo=err)
    return best


def select_theta_gamma(X_train, y_train, name: str = "spdtw",
                       thetas: Sequence[float] = THETA_GRID,
                       gammas: Sequence[float] = GAMMA_GRID,
                       nu: float = 1.0, counts=None,
                       return_curve: bool = False, *, device=None):
    """Joint theta (and gamma for SP-DTW) grid search by LOO 1-NN.

    ``counts`` are the occupancy counts of the train set (computed here
    when None). Returns a Selected with the learned SparsePaths; with
    ``return_curve`` also the (theta, gamma, loo, cells) curve (paper
    Fig. 4).
    """
    if counts is None:
        counts = pairwise_path_counts(
            _as_series(X_train, resolve_device(device)))
    if name == "sp_krdtw":
        gammas = (0.0,)  # the kernel variant uses the support only (Sec. IV)
    best = Selected()
    curve = []
    for theta in thetas:
        for gamma in gammas:
            sp = learn_sparse_paths(None, theta=theta, gamma=gamma,
                                    counts=counts)
            err = _loo(MeasureSpec(name, nu=nu, theta=theta,
                                   weight_gamma=gamma),
                       X_train, y_train, sp=sp, device=device)
            curve.append((theta, gamma, err, sp.n_cells))
            if err < best.loo or (err == best.loo and best.sp is not None
                                  and sp.n_cells < best.sp.n_cells):
                best = Selected(theta=theta, gamma=gamma, nu=nu,
                                loo=err, sp=sp)
    if return_curve:
        return best, curve
    return best
