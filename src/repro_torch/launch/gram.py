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
reference's ``--dryrun`` (an XLA compile of the job for the 512-chip
production mesh) has no counterpart here.

  PYTHONPATH=src python -m repro_torch.launch.gram --n 64 --t 32 \\
      --device cpu
  python -m torch.distributed.run --standalone --nproc_per_node 2 \\
      -m -- repro_torch.launch.gram --kind sp_krdtw --backend gloo \\
      --out /tmp/gram
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

    def job(X, Y):
        xs = stripe(eng._series(X))
        if eng.is_kernel:
            local = eng.gram_log(xs, Y, impl=impl)
        else:
            local = eng.gram(xs, Y, impl=impl, block_a=int(xs.shape[0]))
        return mesh.all_gather_cat(local, dim=0)

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
        device=None):
    """The job on seeded data: X (n, t) standard normal from seed 0, its
    Gram against itself (``mode="gram"``) or its self-queries' 1-NN
    (``"knn"``), with n padded up to a multiple of the group size. Returns
    host arrays: G (n, n), or (nn, dist)."""
    _, size = mesh.world()
    n = -(-n // size) * size
    w = corridor(t)
    job = knn_job(w, kind=kind, device=device) if mode == "knn" else \
        gram_job(w, kind=kind, device=device)
    X = np.random.default_rng(0).normal(size=(n, t)).astype(np.float32)
    if mode == "knn":
        nn, dist = job(X, X)
        return nn.cpu().numpy(), dist.cpu().numpy()
    return job(X, X).cpu().numpy()


def main(argv=None) -> None:
    """CLI entry: ``python -m repro_torch.launch.gram [--n N] [--t T]
    [--kind spdtw|dtw|sp_krdtw] [--mode gram|knn] [--device cpu]``;
    under ``torch.distributed.run`` with ``--backend nccl|gloo``.
    ``--out DIR`` writes the result and each rank's launch counts."""
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
    args = ap.parse_args(argv)
    device = mesh.init_group(args.backend, args.device) \
        if args.backend else args.device
    try:
        t0 = time.perf_counter()
        res = run(args.n, args.t, args.kind, mode=args.mode, device=device)
        wall = time.perf_counter() - t0
        if args.mode == "knn":
            nn, dist = res
            arrays = {"nn": nn, "dist": dist}
            out = {"queries": int(nn.shape[0]),
                   "self_match": float(np.mean(nn == np.arange(len(nn))))}
        else:
            arrays = {"G": res}
            out = {"shape": list(res.shape),
                   "sym_err": float(np.abs(res - res.T).max())}
        out.update(kind=args.kind, mode=args.mode, wall_s=wall)
        mesh.report(args.out, arrays, dict(out, job="gram"))
    finally:
        mesh.destroy_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
