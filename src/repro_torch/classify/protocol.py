"""The paper's evaluation protocol as a public entry: the counterpart of
``benchmarks/common.py`` (``DatasetBench``) and of the tables of
``benchmarks/table{2,4,6}*.py``.

``DatasetBench(name, fast=False, device=None)`` loads one synthetic UCR
dataset (the harness's fast split: 24 train / 40 test series), selects
the meta-parameters on the training series as the paper's Section V-B
does (the Sakoe-Chiba radius, SP-DTW's theta and gamma, K_rdtw's nu,
SP-K_rdtw's theta, each by leave-one-out error), and then gives each
measure's 1-NN error (``knn_err``, paper Table II) or kernel-SVM error
(``svm_err``, Table IV) on the test series with its visited cells (Table
VI) and the time of the Gram. ``paper_tables`` runs the whole protocol
on one dataset and returns the row ``tools/paper_tables_reference.py``
records for the reference; ``mean_ranks``, ``wilcoxon_signed_rank`` and
``compare_rows`` summarise and compare such rows.

Everything computes on ``device``: the card unless the caller names
another (``device="cpu"`` runs the plain versions).

  PYTHONPATH=src python examples/classify_ucr_torch.py --dataset Trace
"""
from __future__ import annotations

import time
from math import erf, sqrt

import numpy as np
import torch

from repro_torch.classify.crossval import (select_nu, select_radius,
                                           select_theta_gamma)
from repro_torch.classify.knn import knn_error
from repro_torch.classify.svm import svm_error
from repro_torch.core import (block_sparsify, make_measure, normalized_gram,
                              pairwise_path_counts)
from repro_torch.core.engine import resolve_device
from repro_torch.data import load

# the protocol's grids and tables, as benchmarks/common.py DatasetBench and
# benchmarks/table{2,4,6}*.py
THETAS = (0, 1, 2, 4, 8)
GAMMAS = (0.0, 0.5)
NUS = (0.1, 0.5, 2.0)
TABLE2 = ("corr", "daco", "euclidean", "dtw", "dtw_sc", "krdtw", "spdtw",
          "sp_krdtw")
TABLE4 = ("euclidean_rbf", "krdtw", "krdtw_sc", "sp_krdtw")
TABLE_TILE = 16
RBF_GAMMA = 0.1
# the entries of a protocol row held against the reference's
TABLE_KEYS = ("T", "n_train", "n_test", "n_classes", "radius", "radius_loo",
              "spdtw_theta", "spdtw_gamma", "spdtw_loo", "nu",
              "sp_krdtw_theta", "sp_krdtw_loo", "knn_error", "svm_error",
              "visited_cells", "tile", "active_tiles", "tiles_total")
# the harness's fast split
FAST = dict(n_train=24, n_test=40)


def _call(name, fn):
    return fn()


class DatasetBench:
    """One dataset's context: the series on ``device``, the occupancy
    counts and the selected meta-parameters (the reference's
    ``DatasetBench``). ``ds`` gives the dataset itself (a ``TSDataset``)
    in place of loading ``name``; ``timer(stage, fn)`` runs each stage of
    the selection (default: calls it)."""

    def __init__(self, name: str, fast: bool = False, device=None, *,
                 ds=None, timer=None):
        run = timer or _call
        self.device = resolve_device(device)
        self.ds = ds if ds is not None else load(name,
                                                 **(FAST if fast else {}))
        self.name = name
        self.Xtr = torch.as_tensor(self.ds.X_train, device=self.device)
        self.Xte = torch.as_tensor(self.ds.X_test, device=self.device)
        self.T = self.ds.T
        ytr = self.ds.y_train
        dev = self.device
        self.counts = run("pairwise_path_counts",
                          lambda: pairwise_path_counts(self.Xtr))
        # meta-parameter selection on train only (paper Sec. V-B)
        self.sel_radius = run("select_radius (K6)", lambda: select_radius(
            self.Xtr, ytr, device=dev))
        self.sel_sp = run("select_theta_gamma spdtw (K1)",
                          lambda: select_theta_gamma(
                              self.Xtr, ytr, name="spdtw",
                              counts=self.counts, thetas=THETAS,
                              gammas=GAMMAS, device=dev))
        self.nu = run("select_nu krdtw (K3)", lambda: select_nu(
            self.Xtr, ytr, name="krdtw", grid=NUS, device=dev)).nu
        self.sel_spk = run("select_theta_gamma sp_krdtw (K3)",
                           lambda: select_theta_gamma(
                               self.Xtr, ytr, name="sp_krdtw",
                               counts=self.counts, thetas=THETAS,
                               nu=self.nu, device=dev))

    def measure(self, name: str):
        sp = {"spdtw": self.sel_sp.sp, "sp_krdtw": self.sel_spk.sp}.get(name)
        return make_measure(name, self.T, sp=sp, nu=self.nu,
                            radius=self.sel_radius.radius,
                            device=self.device)

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out, time.perf_counter() - t0

    def knn_err(self, name: str):
        """(1-NN test error, visited cells, seconds of the Gram)."""
        m = self.measure(name)
        cross, dt = self._timed(lambda: m.cross(self.Xte, self.Xtr))
        return (knn_error(cross, self.ds.y_train, self.ds.y_test),
                m.visited_cells, dt)

    def svm_grams(self, m):
        """The normalised train and test Grams of the kernel measure
        ``m`` (``gram_log``, the self-similarities by one batched
        ``logk``)."""
        lg_tt = m.gram_log(self.Xtr, self.Xtr)
        lg_et = m.gram_log(self.Xte, self.Xtr)
        d_tt = torch.diagonal(lg_tt)
        d_ee = m.logk(self.Xte, self.Xte)
        return (normalized_gram(lg_tt, d_tt, d_tt),
                normalized_gram(lg_et, d_ee, d_tt))

    def svm_err(self, name: str):
        """(kernel-SVM test error, visited cells, seconds of the
        Grams)."""
        m = self.measure(name)
        (Ktr, Kte), dt = self._timed(lambda: self.svm_grams(m))
        return (svm_error(Ktr, Kte, self.ds.y_train, self.ds.y_test,
                          self.ds.n_classes), m.visited_cells, dt)


def rbf_gram(X, Y, gamma=RBF_GAMMA, block=256):
    """exp(-gamma ||x - y||^2) for all pairs, rows in blocks (the Table IV
    Euclidean baseline, ``benchmarks/table4_svm.py``)."""
    return torch.cat([torch.exp(-gamma * torch.sum(
        (X[s:s + block, None, :] - Y[None, :, :]) ** 2, dim=-1))
        for s in range(0, X.shape[0], block)])


def paper_tables(ds, device, timer=None):
    """The protocol of ``benchmarks/common.py`` (``DatasetBench``, with
    Tables II, IV and VI) on the dataset ``ds``, on ``device``: occupancy
    counts, ``select_radius``, ``select_theta_gamma`` for spdtw and
    sp_krdtw, ``select_nu``; the eight 1-NN errors from
    ``make_measure(...).cross``; the SVM errors of the Euclidean RBF and
    the three K_rdtw kernels; visited cells and the active tiles at tile
    16. ``timer(name, fn)`` runs each stage (default: just calls it).
    Returns (row, extras): the row has the keys of
    ``tools/paper_tables_reference.py``; extras hold the measures and
    the spdtw / dtw cross matrices."""
    run = timer or _call
    db = DatasetBench(getattr(ds, "name", ""), device=device, ds=ds,
                      timer=run)
    Xtr, Xte = db.Xtr, db.Xte
    ytr, yte = ds.y_train, ds.y_test
    measures = {m: db.measure(m) for m in TABLE2 + ("krdtw_sc",)}
    knn, crosses = {}, {}
    for m in TABLE2:
        C = run(f"Table II cross {m}",
                lambda m=m: measures[m].cross(Xte, Xtr))
        knn[m] = knn_error(C, ytr, yte)
        if m in ("spdtw", "dtw"):
            crosses[m] = C
    svm = {"euclidean_rbf": run("Table IV euclidean_rbf Grams + svm_error",
                                lambda: svm_error(
                                    rbf_gram(Xtr, Xtr), rbf_gram(Xte, Xtr),
                                    ytr, yte, ds.n_classes))}
    for m in TABLE4[1:]:
        Ktr, Kte = run(f"Table IV {m} Grams (K3) + self-similarities (K4)",
                       lambda m=m: db.svm_grams(measures[m]))
        svm[m] = run(f"Table IV {m} svm_error",
                     lambda: svm_error(Ktr, Kte, ytr, yte, ds.n_classes))
    bsp = block_sparsify(db.sel_sp.sp, tile=TABLE_TILE)
    row = {"T": int(db.T), "n_train": len(ds.X_train),
           "n_test": len(ds.X_test), "n_classes": int(ds.n_classes),
           "radius": int(db.sel_radius.radius),
           "radius_loo": float(db.sel_radius.loo),
           "spdtw_theta": float(db.sel_sp.theta),
           "spdtw_gamma": float(db.sel_sp.gamma),
           "spdtw_loo": float(db.sel_sp.loo), "nu": float(db.nu),
           "sp_krdtw_theta": float(db.sel_spk.theta),
           "sp_krdtw_loo": float(db.sel_spk.loo), "knn_error": knn,
           "svm_error": svm,
           "visited_cells": {m: int(v.visited_cells)
                             for m, v in measures.items()},
           "tile": TABLE_TILE, "active_tiles": int(bsp.n_active),
           "tiles_total": int(bsp.active.size)}
    return row, {"measures": measures, "crosses": crosses,
                 "sel_sp": db.sel_sp, "Xtr": Xtr, "Xte": Xte}


# errors and LOOs are float32 fractions k / n, which the two packages
# round differently in the last bit (XLA's mean multiplies by 1 / n): two
# values within FRACTION_ATOL are the same fraction for any n <= 10^5
FRACTION_ATOL = 1e-6


def _same(g, w) -> bool:
    if isinstance(w, float) and isinstance(g, (int, float)):
        return abs(g - w) <= FRACTION_ATOL
    return g == w


def compare_rows(got, want):
    """The entries of TABLE_KEYS where a protocol row differs from the
    reference's, as "key: got != want" strings (every count and selection
    equal; errors and LOOs the same fraction, within FRACTION_ATOL)."""
    bad = []
    for k in TABLE_KEYS:
        g, w = got.get(k), want.get(k)
        if isinstance(w, dict):
            g = g or {}
            bad += [f"{k}.{m}: {g.get(m)} != {w[m]}"
                    for m in w if not _same(g.get(m), w[m])]
        elif not _same(g, w):
            bad.append(f"{k}: {g} != {w}")
    return bad


def mean_ranks(mat, names):
    """Mean rank of each column over the rows of an error matrix, ties
    taking their average rank (``benchmarks/table2_knn.py``)."""
    ranks = np.argsort(np.argsort(mat, axis=1), axis=1) + 1.0
    for i in range(mat.shape[0]):
        for v in np.unique(mat[i]):
            sel = mat[i] == v
            if sel.sum() > 1:
                ranks[i, sel] = ranks[i, sel].mean()
    return {m: float(r) for m, r in zip(names, ranks.mean(axis=0))}


def wilcoxon_signed_rank(a, b) -> float:
    """Two-sided Wilcoxon signed-rank p-value (normal approximation), as
    ``benchmarks/common.py`` computes it: zeros dropped, ties averaged,
    1.0 below six nonzero differences."""
    d = np.asarray(a, float) - np.asarray(b, float)
    d = d[d != 0]
    n = len(d)
    if n < 6:
        return 1.0
    ranks = np.argsort(np.argsort(np.abs(d))) + 1.0
    order = np.abs(d)
    for v in np.unique(order):
        sel = order == v
        if sel.sum() > 1:
            ranks[sel] = ranks[sel].mean()
    w = min(ranks[d > 0].sum(), ranks[d < 0].sum())
    mu = n * (n + 1) / 4
    sigma = np.sqrt(n * (n + 1) * (2 * n + 1) / 24)
    z = (w - mu + 0.5) / sigma
    p = 2 * 0.5 * (1 + erf(z / sqrt(2)))
    return min(max(p, 0.0), 1.0)


def summary(rows, names, key):
    """Mean ranks and pairwise Wilcoxon p-values of one table over the
    rows {dataset: row}."""
    mat = np.array([[rows[d][key][m] for m in names] for d in rows])
    wil = {f"{a}|{b}": wilcoxon_signed_rank(mat[:, i], mat[:, j])
           for i, a in enumerate(names) for j, b in enumerate(names)
           if j > i}
    return mean_ranks(mat, names), wil
