"""Distributed soft-SP-DTW centroid fitting: the counterpart of
``repro.launch.cluster``.

Barycenter fitting is embarrassingly parallel over centroids, so the job
mirrors ``launch/gram.py``: the centroid rows Z0 (k, T) and their member
weight rows A (k, N) are striped over the ranks of the default process
group (``launch/mesh.py``), the members X (N, T) are whole on every rank,
and each rank fits its rows with the port's ``soft_barycenter`` (the stash
forward K8 and the reverse sweep K9 on the card, the in-house AdamW), one
row after another; the fitted stripe and the final losses are
all-gathered at the end, the only communication. The reference vmaps one
barycenter per row; the loop per row keeps each row's arithmetic
independent of the stripe, so any group size gives the one-rank result
bit for bit. The weight grid (a T / 8 corridor here, as in the
reference) is fitted once per job. Without a group the job runs as one
rank (the reference's 1 x 1 host mesh).

``dryrun`` (``--dryrun [--multi-pod]``) counts one rank's work on the
256- or 512-rank production layout, as ``launch/gram.py``'s does (the
kernels are bound through ``ctypes``, which fake tensors cannot pass):
each Adam step of each of the rank's centroid rows is one paired soft
forward with its stash (K8) and one reverse sweep (K9) against the N
members, over the plan's cells a pair, at the per-cell work of
``launch.cost_analysis`` (``soft_fwd_flops`` / ``soft_bwd_flops``).
Bytes are the rank's rows, the members and the weights read once and its
centroids and losses written once; the temporary is one step's stash,
(active tiles x S^2) float32 values a pair.

  PYTHONPATH=src python -m repro_torch.launch.cluster --k 8 --n 64 \\
      --t 64 --device cpu
  python -m torch.distributed.run --standalone --nproc_per_node 2 \\
      -m -- repro_torch.launch.cluster --backend gloo --out /tmp/cluster
  PYTHONPATH=src python -m repro_torch.launch.cluster --dryrun
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.engine import engine_for
from repro_torch.launch import mesh
from repro_torch.launch.gram import corridor, stripe


def cluster_job(weights, gamma: float = 0.1, *, steps: int = 30,
                lr: float = 0.05, device=None):
    """Build the distributed barycenter fit: a function (Z0 (k, T) initial
    centroids, X (N, T) members, A (k, N) non-negative member weights) ->
    (Z (k, T) fitted centroids, final per-centroid loss (k,)) on every
    rank. k must divide over the ranks; an all-zero A row comes back
    untouched."""
    eng = engine_for("spdtw", weights=np.asarray(weights, np.float32),
                     gamma=gamma, device=device)

    def job(Z0, X, A):
        X = eng._series(X)
        Z, L = [], []
        for z0, a in zip(stripe(eng._series(Z0)), stripe(eng._series(A))):
            z, losses = eng.barycenter(X, init=z0, steps=steps, lr=lr,
                                       sample_weights=a)
            Z.append(z)
            L.append(losses[-1])
        return (mesh.all_gather_cat(torch.stack(Z)),
                mesh.all_gather_cat(torch.stack(L)))

    return job


def run(k: int = 8, n: int = 64, t: int = 64, gamma: float = 0.1,
        steps: int = 20, device=None):
    """The job on seeded data (the reference's draws): X (n, t) standard
    normal, a random assignment of the members to k centroids as one-hot
    weight rows, each centroid started at its members' mean (zeros when
    it has none); k is padded up to a multiple of the group size.
    Returns host arrays (Z (k, t), final losses (k,))."""
    _, size = mesh.world()
    k = -(-k // size) * size
    job = cluster_job(corridor(t), gamma, steps=steps, device=device)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, t)).astype(np.float32)
    assign = rng.integers(0, k, size=n)
    A = (assign[None, :] == np.arange(k)[:, None]).astype(np.float32)
    Z0 = np.stack([X[assign == c].mean(axis=0) if (assign == c).any()
                   else np.zeros(t) for c in range(k)]).astype(np.float32)
    Z, loss = job(Z0, X, A)
    return Z.cpu().numpy(), loss.cpu().numpy()


def dryrun(k: int = 512, n: int = 2048, t: int = 128, gamma: float = 0.1,
           steps: int = 30, layout=None) -> dict:
    """One rank's counted work of the job over ``layout`` (one rank
    without one), the reference's dry-run keys: see the module
    docstring."""
    from repro_torch.launch import cost_analysis as ca
    size = 1 if layout is None else layout.size(layout.axes)
    k = -(-k // size) * size
    rows = k // size
    eng = engine_for("spdtw", weights=corridor(t), gamma=gamma, device="cpu")
    per_pair = int(eng.measure.visited_cells)
    pairs = rows * n * steps
    flops = pairs * per_pair * (ca.soft_fwd_flops(1) + ca.soft_bwd_flops(1))
    stash = n * eng.bsp.n_active * eng.bsp.tile ** 2 * 4
    return {"mode": "cluster", "flops_per_device": float(flops),
            "bytes_per_device": float((rows * t + n * t + rows * n) * 4
                                      + (rows * t + rows) * 4),
            "temp_bytes": stash, "devices": size, "centroids": k,
            "steps": steps, "cells_per_pair": per_pair,
            "cells_per_device": pairs * per_pair}


def main(argv=None) -> None:
    """CLI entry: ``python -m repro_torch.launch.cluster [--k K] [--n N]
    [--t T] [--gamma G] [--steps S] [--device cpu]``; under
    ``torch.distributed.run`` with ``--backend nccl|gloo``. ``--out DIR``
    writes the centroids, the losses and each rank's launch counts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--t", type=int, default=128)
    ap.add_argument("--gamma", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=30)
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
            print(json.dumps(dryrun(args.k, args.n, args.t, args.gamma,
                                    args.steps, mesh.make_production_mesh(
                                        multi_pod=args.multi_pod))))
        return
    device = mesh.init_group(args.backend, args.device) \
        if args.backend else args.device
    try:
        t0 = time.perf_counter()
        Z, loss = run(args.k, args.n, args.t, args.gamma, args.steps,
                      device=device)
        wall = time.perf_counter() - t0
        out = {"centroids": list(Z.shape),
               "mean_final_loss": float(loss.mean()), "wall_s": wall}
        mesh.report(args.out, {"Z": Z, "loss": loss},
                    dict(out, job="cluster"))
    finally:
        mesh.destroy_group()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
