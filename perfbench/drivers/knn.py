"""The SP-DTW 1-NN deployment: the port's ``core.engine.fit`` learns the
support, plans the tiles and indexes the train split; bulk jobs go
through ``SimilarityEngine.knn`` (the exact cascade) and online steps
through ``launch.search.SearchEngine.search`` in cascade mode.

``judge`` holds what the window served against the plain reference: the
support re-learnt from the train split, and each sampled answer's
neighbour and distance against the reference's SP-DTW to every train
series.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.reference import occupancy, spdtw


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The port, set up for one cell; ``step`` serves one batch and
    returns its answers on the host."""

    def __init__(self, cfg: dict, wl: dict, device: torch.device):
        self.cfg, self.wl, self.device = cfg, wl, device
        self.engine = self.server = None

    def setup(self, X_train, y_train) -> dict:
        from repro_torch.core.engine import fit
        from repro_torch.core.spec import MeasureSpec
        m = self.cfg["measure"]
        spec = MeasureSpec(family="spdtw", support="learned",
                           theta=float(m["theta"]),
                           weight_gamma=float(m["weight_gamma"]),
                           tile=m.get("tile"))
        _sync(self.device)
        t0 = time.perf_counter()
        self.engine = fit(spec, X_train, labels=y_train, device=self.device)
        _sync(self.device)
        fit_ms = (time.perf_counter() - t0) * 1e3
        if self.wl["entry"] == "search":
            from repro_torch.launch.search import SearchEngine
            self.server = SearchEngine(None, engine=self.engine,
                                       mode="cascade")
        return {"fit_ms": fit_ms}

    def step(self, Q) -> dict:
        if self.server is not None:
            nn, dist = self.server.search(Q)
            return {"nn": nn, "dist": dist}
        nn, dist = self.engine.knn(Q)
        return {"nn": nn.cpu().numpy(), "dist": dist.cpu().numpy()}

    def support(self) -> dict:
        sp = self.engine.sp
        return {"counts": sp.counts.cpu().numpy().astype(np.int64),
                "support": sp.support.cpu().numpy(),
                "cells": int(sp.support.sum())}

    def counters(self, Q) -> dict:
        """The cascade's own counters over one batch (host reads: taken
        after the window)."""
        _, _, st = self.engine.knn(Q, return_stats=True)
        return {"pre_dp_prune": float(st["pre_dp_prune"]),
                "dp_pairs": int(st["dp_pairs"])}

    def kept(self) -> dict:
        return {}

    def release(self) -> None:
        self.engine = self.server = None


def judge(cfg, X_train, Q, served: dict, support: dict) -> dict:
    """The compared numbers: the support against the float32 reference's
    re-learnt one (cells that differ; count difference over all counts),
    and the served neighbours and distances of the queries ``Q`` against
    the reference's SP-DTW (the worst relative excess of the served
    neighbour over the best, and the worst relative distance error)."""
    m = cfg["measure"]
    counts = occupancy.path_counts(X_train, torch.float32)
    sup, w = occupancy.learn_support(counts, m["theta"], m["weight_gamma"])
    c_ref = counts.cpu().numpy().astype(np.float64)
    D = spdtw.spdtw_cross(Q, X_train, w, torch.float32).double().cpu()
    best = D.min(dim=1).values
    nn = torch.as_tensor(np.asarray(served["nn"], np.int64))
    got = D[torch.arange(len(nn)), nn]
    dist = torch.as_tensor(np.asarray(served["dist"], np.float64))
    floor = best.clamp_min(1e-12)
    return {
        "support_cells": float(np.sum(sup != support["support"])),
        "count_err": float(np.abs(c_ref - support["counts"]).sum()
                           / c_ref.sum()),
        "nn_gap": float(((got - best) / floor).max()),
        "dist_err": float(((dist - best).abs() / floor).max()),
    }


class Control(Program):
    """The plain reference in bfloat16, the precision below the
    configuration's float32, in the program's place: the control the
    comparison has to refuse."""

    def setup(self, X_train, y_train) -> dict:
        m = self.cfg["measure"]
        self.X = X_train
        self.counts = occupancy.path_counts(X_train, torch.bfloat16)
        self.sup, self.w = occupancy.learn_support(
            self.counts, m["theta"], m["weight_gamma"])
        return {"fit_ms": float("nan")}

    def step(self, Q) -> dict:
        best = spdtw.spdtw_cross(Q, self.X, self.w, torch.bfloat16).min(1)
        return {"nn": best.indices.cpu().numpy(),
                "dist": best.values.cpu().numpy()}

    def support(self) -> dict:
        return {"counts": self.counts.cpu().numpy(), "support": self.sup,
                "cells": int(self.sup.sum())}

    def counters(self, Q) -> dict:
        return {}

    def release(self) -> None:
        self.X = None


def compare(cfg, wl, data, res, support, kept, rng, device) -> dict:
    """Judge a sample of the answers served in the window, drawn with
    ``rng``: at most ``check_sample`` of them."""
    n = res["answered"]
    idx = np.sort(rng.choice(n, min(n, int(wl["check_sample"])),
                             replace=False))
    Q = torch.as_tensor(data["pool"][res["rows"][idx]], device=device)
    served = {k: v[idx] for k, v in res["answers"].items()}
    X = torch.as_tensor(data["X_train"], device=device)
    return judge(cfg, X, Q, served, support)
