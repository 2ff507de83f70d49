"""Distributed SP-DTW / K_rdtw Gram and exact 1-NN jobs: the counterpart
of ``repro.launch.gram`` (the paper's production workload: 1-NN and the
SVM need all-pairs (dis)similarities over large series sets).

The reference tiles the N x M pair matrix row-wise over the flattened
device mesh with ``shard_map``. Here the ranks of the default process
group (``launch/mesh.py``) take its place: rank r computes the row stripe
r of X against the whole second set on its own device (``engine.gram``:
K1 over the active tiles for spdtw, over the all-ones plan for dtw;
``engine.gram_log``: K3, for the kernel kinds, whose raw log-kernel values
the SVM reads), and one all-gather reassembles the matrix. The support
(a Sakoe-Chiba corridor of T / 8 here, as in the reference) is fitted
once per job, before any stripe runs. ``mode="knn"`` swaps the Gram for
the exact 1-NN cascade: queries are striped, the corpus is whole on
every rank (``with_corpus`` per rank), and each rank bounds-prunes its
stripe (K2 seeds, K1 prefix bound and survivors).

Without a process group the job runs as one rank: the counterpart of the
reference's 1 x 1 host mesh. A stripe's arithmetic does not depend on the
stripe, so any group size gives the one-rank result bit for bit. The
Gram job reports the DP cells it visits on this rank (``job.
visited_cells``: the stripe's pairs times the plan's cells a pair).

``dryrun`` (``--dryrun [--multi-pod]``) is the counterpart of the
reference's XLA compile for the production mesh: one rank's work on the
256- or 512-rank layout (``mesh.make_production_mesh`` on a fake group),
counted, not traced, since the kernels are bound through ``ctypes``
(``kernels/_build.py``), which fake tensors cannot pass. The count is
the rank's stripe times the plan's kept cells a pair (the engine is
fitted here, on the CPU, as the job fits it) times each cell's work of
K1 (spdtw, dtw) or K3 (sp_krdtw), the formulas of
``launch.cost_analysis`` that the kernel table's bounds use; bytes are
the stripe and the second set read once and the stripe's block written
once. The knn mode counts every pair (the cascade's worst case: what it
prunes depends on the data).

  PYTHONPATH=src python -m repro_torch.launch.gram --n 64 --t 32 \\
      --device cpu
  python -m torch.distributed.run --standalone --nproc_per_node 2 \\
      -m -- repro_torch.launch.gram --kind sp_krdtw --backend gloo \\
      --out /tmp/gram
  PYTHONPATH=src python -m repro_torch.launch.gram --dryrun --multi-pod
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.dtw import band_mask
from repro_torch.core.engine import engine_for
from repro_torch.launch import mesh


def stripe(X: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous row stripe of ``X`` (all of it without a
    group); the rows must divide evenly over the ranks."""
    rank, size = mesh.world()
    n = int(X.shape[0])
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} ranks (pad "
                         f"them to a multiple, as run does)")
    rows = n // size
    return X[rank * rows:(rank + 1) * rows]


def corridor(t: int) -> np.ndarray:
    """The jobs' (t, t) weight grid: a Sakoe-Chiba corridor of half-width
    max(t // 8, 1), unit weights."""
    return band_mask(t, t, max(t // 8, 1)).numpy().astype(np.float32)


def gram_job(weights, kind: str = "spdtw", nu: float = 1.0,
             tile=None, impl: str = "auto", device=None):
    """Build the distributed Gram computation: a function (X (N, T), Y
    (M, T)) -> (N, M) on every rank.

    ``weights`` is the (T, T) grid (the learned support or a corridor;
    ignored for dtw): the engine is fitted here, so its plan exists
    before any stripe runs. Dissimilarity kinds return ``engine.gram``,
    the kernel kinds their raw log-kernel values (``gram_log``)."""
    w = np.asarray(weights, np.float32)
    eng = engine_for(kind, weights=None if kind == "dtw" else w, nu=nu,
                     tile=tile, T=w.shape[0], device=device)
    per_pair = int(eng.measure.visited_cells)

    def job(X, Y):
        xs = stripe(eng._series(X))
        if eng.is_kernel:
            local = eng.gram_log(xs, Y, impl=impl)
        else:
            local = eng.gram(xs, Y, impl=impl, block_a=int(xs.shape[0]))
        job.visited_cells = int(local.shape[0]) * int(local.shape[1]) \
            * per_pair
        return mesh.all_gather_cat(local, dim=0)

    job.visited_cells = 0
    return job


def knn_job(weights, kind: str = "spdtw", impl: str = "auto",
            seed_k: int = 2, prefix_frac: float = 0.5, device=None):
    """Build the distributed exact 1-NN cascade: a function (Q (B, T),
    C (N, T)) -> (nn (B,) int32, dist (B,)) on every rank. Queries are
    striped over the ranks, the corpus is indexed whole on each
    (``with_corpus`` on the support fitted here). Only the dissimilarity
    kinds have admissible bounds."""
    if kind not in ("dtw", "spdtw"):
        raise ValueError(f"knn cascade has no admissible bounds for "
                         f"{kind!r}; use mode='gram'")
    w = np.asarray(weights, np.float32)
    base = engine_for(kind, weights=None if kind == "dtw" else w,
                      T=w.shape[0], device=device)

    def job(Q, C):
        eng = base.with_corpus(C)
        nn, dist = eng.knn(stripe(eng._series(Q)), impl=impl,
                           seed_k=seed_k, prefix_frac=prefix_frac)
        return mesh.all_gather_cat(nn), mesh.all_gather_cat(dist)

    return job


def run(n: int = 64, t: int = 64, kind: str = "spdtw", mode: str = "gram",
        device=None, stats=None):
    """The job on seeded data: X (n, t) standard normal from seed 0, its
    Gram against itself (``mode="gram"``) or its self-queries' 1-NN
    (``"knn"``), with n padded up to a multiple of the group size. Returns
    host arrays: G (n, n), or (nn, dist). A dict ``stats`` gets the Gram
    job's ``visited_cells`` on this rank."""
    _, size = mesh.world()
    n = -(-n // size) * size
    w = corridor(t)
    job = knn_job(w, kind=kind, device=device) if mode == "knn" else \
        gram_job(w, kind=kind, device=device)
    X = np.random.default_rng(0).normal(size=(n, t)).astype(np.float32)
    if mode == "knn":
        nn, dist = job(X, X)
        return nn.cpu().numpy(), dist.cpu().numpy()
    G = job(X, X).cpu().numpy()
    if stats is not None:
        stats["visited_cells"] = job.visited_cells
    return G


def dryrun(n: int = 2048, t: int = 128, kind: str = "spdtw",
           mode: str = "gram", layout=None) -> dict:
    """One rank's counted work of the job over ``layout`` (a
    ``mesh.Layout``, one rank without one), the reference's dry-run keys
    and the cells: see the module docstring."""
    from repro_torch.launch import cost_analysis as ca
    size = 1 if layout is None else layout.size(layout.axes)
    n = -(-n // size) * size
    rows = n // size
    eng = engine_for(kind, weights=None if kind == "dtw" else corridor(t),
                     T=t, device="cpu")
    per_pair = int(eng.measure.visited_cells)
    pairs = rows * n
    if kind == "sp_krdtw":
        flops = pairs * (per_pair * ca.KRDTW_FLOPS
                         + (2 * t - 2) * ca.KRDTW_DIAG_FLOPS)
    else:
        flops = pairs * per_pair * (ca.spdtw_flops(1) if kind == "spdtw"
                                    else ca.dtw_flops(1))
    out_bytes = rows * n * 4 if mode == "gram" else rows * 8
    return {"mode": mode, "flops_per_device": float(flops),
            "bytes_per_device": float((rows + n) * t * 4 + out_bytes),
            "temp_bytes": out_bytes, "devices": size, "pairs": n * n,
            "cells_per_pair": per_pair, "cells_per_device": pairs * per_pair}


def main(argv=None) -> None:
    """CLI entry: ``python -m repro_torch.launch.gram [--n N] [--t T]
    [--kind spdtw|dtw|sp_krdtw] [--mode gram|knn] [--device cpu]``;
    under ``torch.distributed.run`` with ``--backend nccl|gloo``.
    ``--out DIR`` writes the result and each rank's launch counts.
    ``--dryrun [--multi-pod]`` prints one rank's counted work on the
    production layout (a fake group of 256 or 512 ranks)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--t", type=int, default=128)
    ap.add_argument("--kind", default="spdtw",
                    choices=("spdtw", "dtw", "sp_krdtw"))
    ap.add_argument("--mode", default="gram", choices=("gram", "knn"))
    ap.add_argument("--device", default=None,
                    help="where to compute (default: the CUDA card)")
    ap.add_argument("--backend", default=None, choices=mesh.BACKENDS,
                    help="collective backend of a launched job")
    ap.add_argument("--out", default=None,
                    help="directory for the result and the ranks' launch "
                         "counts")
    ap.add_argument("--dryrun", action="store_true",
                    help="count one rank's work on the production layout")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if args.dryrun:
        with mesh.fake_world(512 if args.multi_pod else 256):
            print(json.dumps(dryrun(args.n, args.t, args.kind, args.mode,
                                    mesh.make_production_mesh(
                                        multi_pod=args.multi_pod))))
        return
    device = mesh.init_group(args.backend, args.device) \
        if args.backend else args.device
    stats = {}
    try:
        t0 = time.perf_counter()
        res = run(args.n, args.t, args.kind, mode=args.mode, device=device,
                  stats=stats)
        wall = time.perf_counter() - t0
        if args.mode == "knn":
            nn, dist = res
            arrays = {"nn": nn, "dist": dist}
            out = {"queries": int(nn.shape[0]),
                   "self_match": float(np.mean(nn == np.arange(len(nn))))}
        else:
            arrays = {"G": res}
            out = {"shape": list(res.shape),
                   "sym_err": float(np.abs(res - res.T).max()),
                   "visited_cells": stats["visited_cells"]}
        out.update(kind=args.kind, mode=args.mode, wall_s=wall)
        mesh.report(args.out, arrays, dict(out, job="gram"))
    finally:
        mesh.destroy_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
