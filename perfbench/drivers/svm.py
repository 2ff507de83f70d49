"""The SP-K_rdtw SVM deployment: the port's ``core.engine.fit`` learns
the support from the train split; set-up fits the SVM on the
cosine-normalised train Gram (``engine.gram_log``, K3) with C chosen by
the protocol's 3-fold cross-validation (``classify.svm.svm_fit`` /
``svm_predict``); a step runs ``engine.gram_log`` (K3) against the train
split, ``engine.pairs`` (K4) for the self-similarities,
``core.krdtw.normalized_gram`` and ``classify.svm.svm_predict``.

``judge`` holds what the window served against the plain reference: the
support re-learnt from the train split, the served normalised Gram rows,
and each sampled label against the decision values of the reference's
own SVM (its Grams, its C, its alphas).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.reference import krdtw, occupancy, svm

C_GRID = (0.1, 1.0, 10.0, 100.0)
FOLDS = 3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port, set up for one cell; ``step`` serves one batch and
    returns its labels on the host, and keeps the normalised Gram rows of
    the largest batch served last for the comparison."""

    def __init__(self, cfg: dict, wl: dict, device: torch.device):
        self.cfg, self.wl, self.device = cfg, wl, device
        self.engine = None
        self._kept = (0, None)

    def setup(self, X_train, y_train) -> dict:
        from repro_torch.classify.svm import svm_fit, svm_predict
        from repro_torch.core.engine import fit
        from repro_torch.core.krdtw import normalized_gram
        from repro_torch.core.spec import MeasureSpec
        m = self.cfg["measure"]
        spec = MeasureSpec(family="sp_krdtw", support="learned",
                           theta=float(m["theta"]), nu=float(m["nu"]))
        _sync(self.device)
        t0 = time.perf_counter()
        self.engine = fit(spec, support_corpus=X_train, T=X_train.shape[1],
                          device=self.device)
        _sync(self.device)
        fit_ms = (time.perf_counter() - t0) * 1e3
        eng = self.engine
        self.X = eng._series(X_train)
        self.y = torch.as_tensor(np.asarray(y_train), device=self.device)
        self.k = int(self.cfg["n_classes"])
        lg = eng.gram_log(self.X, self.X)
        self.d_train = torch.diagonal(lg).clone()
        K = normalized_gram(lg, self.d_train, self.d_train)
        n = K.shape[0]
        folds = np.array_split(np.random.default_rng(0).permutation(n),
                               FOLDS)

        def cv_err(C):
            errs = []
            for f in range(FOLDS):
                va = torch.as_tensor(folds[f], device=self.device)
                tr = torch.as_tensor(np.concatenate(
                    [folds[g] for g in range(FOLDS) if g != f]),
                    device=self.device)
                k_cv = int(self.y.max()) + 1
                al = svm_fit(K[tr][:, tr], self.y[tr], k_cv, C)
                pred = svm_predict(al, K[va][:, tr], self.y[tr], k_cv)
                errs.append(float((pred != self.y[va]).float().mean()))
            return float(np.mean(errs))

        self.C = min(C_GRID, key=cv_err)
        self.alphas = svm_fit(K, self.y, self.k, self.C)
        _sync(self.device)
        return {"fit_ms": fit_ms,
                "svm_ms": (time.perf_counter() - t0) * 1e3 - fit_ms,
                "C": self.C}

    def step(self, Q) -> dict:
        from repro_torch.classify.svm import svm_predict
        from repro_torch.core.krdtw import normalized_gram
        eng = self.engine
        lg = eng.gram_log(Q, self.X)
        d = -eng.pairs(Q, Q)
        K = normalized_gram(lg, d, self.d_train)
        labels = svm_predict(self.alphas, K, self.y, self.k).cpu().numpy()
        if Q.shape[0] >= self._kept[0]:
            self._kept = (Q.shape[0], (Q, K))
        return {"label": labels}

    def support(self) -> dict:
        sp = self.engine.sp
        return {"counts": sp.counts.cpu().numpy().astype(np.int64),
                "support": sp.support.cpu().numpy(),
                "cells": int(sp.support.sum())}

    def counters(self, Q) -> dict:
        return {}

    def kept(self) -> dict:
        """The queries and normalised Gram rows of the kept step."""
        if self._kept[1] is None:
            return {}
        Q, K = self._kept[1]
        return {"Q": Q.detach().clone(), "K": K.cpu().numpy()}

    def release(self) -> None:
        self.engine = self.X = self.alphas = None
        self._kept = (0, None)


def reference_model(X_train, y_train, cfg, dtype):
    """The plain reference's own SVM in ``dtype``: support, normalised
    train Gram, C and alphas."""
    m = cfg["measure"]
    counts = occupancy.path_counts(X_train, dtype)
    sup, _ = occupancy.learn_support(counts, m["theta"], 0.0)
    lg = krdtw.log_krdtw_cross(X_train, X_train, m["nu"], sup, dtype,
                               upper=True)
    d = torch.diagonal(lg).clone()
    K = svm.normalized(lg, d, d)
    y = torch.as_tensor(np.asarray(y_train), device=X_train.device)
    C = svm.select_c(K, y, int(cfg["n_classes"]))
    alphas = svm.fit(K, y, int(cfg["n_classes"]), C)
    return {"counts": counts, "support": sup, "d": d, "C": C,
            "alphas": alphas, "y": y}


def reference_rows(model, X_train, Q, cfg, dtype):
    """(normalised Gram rows (S, N), decision values (S, k)) of queries
    ``Q`` under a reference model."""
    nu = cfg["measure"]["nu"]
    lg = krdtw.log_krdtw_cross(Q, X_train, nu, model["support"], dtype)
    dq = krdtw.log_krdtw_pairs(Q, Q, nu, model["support"], dtype)
    K = svm.normalized(lg, dq, model["d"])
    return K, svm.decisions(model["alphas"], K, model["y"],
                            int(cfg["n_classes"]))


def judge(cfg, X_train, y_train, Q, served: dict, support: dict,
          KQ=None, K_served=None) -> dict:
    """The compared numbers: the support against the float32 reference's
    (cells that differ; count difference over all counts); the served
    normalised Gram rows of ``KQ`` (worst absolute difference); the
    served labels of ``Q`` against the reference SVM's decision values
    (the worst shortfall of the served class's value below the best, over
    the row's largest |value|)."""
    model = reference_model(X_train, y_train, cfg, torch.float32)
    c_ref = model["counts"].cpu().numpy().astype(np.float64)
    _, dec = reference_rows(model, X_train, Q, cfg, torch.float32)
    dec = dec.double().cpu()
    lab = torch.as_tensor(np.asarray(served["label"], np.int64))
    got = dec[torch.arange(len(lab)), lab]
    best = dec.max(dim=1).values
    scale = dec.abs().max(dim=1).values.clamp_min(1e-30)
    out = {
        "support_cells": float(np.sum(model["support"]
                                      != support["support"])),
        "count_err": float(np.abs(c_ref - support["counts"]).sum()
                           / c_ref.sum()),
        "label_gap": float(((best - got) / scale).max()),
    }
    if KQ is not None:
        K_ref, _ = reference_rows(model, X_train, KQ, cfg, torch.float32)
        out["gram_err"] = float(np.abs(K_ref.cpu().numpy()
                                       - np.asarray(K_served)).max())
    return out


class Control(Program):
    """The plain reference in bfloat16, the precision below the
    configuration's float32, in the program's place: the control the
    comparison has to refuse."""

    def setup(self, X_train, y_train) -> dict:
        self.X = X_train
        self.model = reference_model(X_train, y_train, self.cfg,
                                     torch.bfloat16)
        return {"fit_ms": float("nan"), "C": self.model["C"]}

    def step(self, Q) -> dict:
        K, dec = reference_rows(self.model, self.X, Q, self.cfg,
                                torch.bfloat16)
        if Q.shape[0] >= self._kept[0]:
            self._kept = (Q.shape[0], (Q, K.float()))
        return {"label": dec.argmax(dim=1).cpu().numpy()}

    def support(self) -> dict:
        return {"counts": self.model["counts"].cpu().numpy(),
                "support": self.model["support"],
                "cells": int(self.model["support"].sum())}

    def release(self) -> None:
        self.X = self.model = None
        self._kept = (0, None)


def compare(cfg, wl, data, res, support, kept, rng, device) -> dict:
    """Judge a sample of the labels served in the window and a sample of
    the kept step's normalised Gram rows, both drawn with ``rng``."""
    n = res["answered"]
    idx = np.sort(rng.choice(n, min(n, int(wl["check_sample"])),
                             replace=False))
    Q = torch.as_tensor(data["pool"][res["rows"][idx]], device=device)
    served = {k: v[idx] for k, v in res["answers"].items()}
    X = torch.as_tensor(data["X_train"], device=device)
    KQ = K_served = None
    if kept:
        m = kept["K"].shape[0]
        rows = np.sort(rng.choice(m, min(m, int(wl["check_gram_rows"])),
                                  replace=False))
        KQ, K_served = kept["Q"][torch.as_tensor(rows, device=device)], \
            kept["K"][rows]
    return judge(cfg, X, data["y_train"], Q, served, support, KQ, K_served)
