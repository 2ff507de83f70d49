"""Streaming SP-DTW similarity search: the serving side of the port.

A fixed corpus is indexed once (``fit``: envelopes, support windows,
block-sparse tile plan), then a stream of 1-NN queries is served
continuous-batching style: requests join at the next step boundary,
each step runs one cascade batch, finished slots free up for the next
arrivals. Every batch runs bounds -> survivors -> masked DP
(``kernels.ops._knn_cascade``: K2 seeds, K1 prefix bound and survivors
on the card) and reports per-stage prune rates; the answers equal the
full Gram argmin bit for bit.

With ``--centroids N`` the engine serves nearest-centroid: N soft-SP-DTW
barycenters per class (K8 / K9) are fitted on the corpus labels at
start-up and each query pays k = n_classes * N masked DPs (K1) instead of
a corpus-sized cascade. With ``--sketch R`` it serves through the Random
Warping Series tier (K1 embedding, matmul shortlist, K2 re-rank).

Entry points compute on the CUDA card unless given ``device="cpu"``
(``--device cpu``), and raise when no card is present:

  PYTHONPATH=src python -m repro_torch.launch.search --dataset CBF
  PYTHONPATH=src python -m repro_torch.launch.search --workload retrieval \\
      --check
  PYTHONPATH=src python -m repro_torch.launch.search --workload classify \\
      --centroids 1 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine import fit, resolve_device
from repro_torch.core.occupancy import SparsePaths, learn_sparse_paths
from repro_torch.core.spec import MeasureSpec
from repro_torch.launch.stats import percentiles

_STAT_KEYS = ("stage1_prune", "stage2_prune", "stage3_prune",
              "pre_dp_prune", "dp_abandoned")
_SKETCH_STAT_KEYS = ("shortlist_prune", "bound_prune", "pre_dp_prune")


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class QueryResult:
    """One served query: neighbour, distance, and stream bookkeeping."""
    rid: int
    nn: int
    dist: float
    label: Optional[int]
    submitted_step: int
    completed_step: int

    @property
    def wait_steps(self) -> int:
        """Streaming-loop steps between submission and completion."""
        return self.completed_step - self.submitted_step


class SearchEngine:
    """1-NN / nearest-centroid serving shell over a ``SimilarityEngine``.

    Construction fits the engine once (support, tile plan, corpus index)
    unless ``engine=`` or ``refresh=`` hands one over; ``search`` then
    serves any number of query batches against it and returns host numpy
    arrays, so the wall-clock of each batch includes the card's work.

    ``mode="cascade"`` (default) is the exact 1-NN lower-bound cascade; a
    fitted ``centroid_model`` only seeds its thresholds.
    ``mode="centroid"`` serves the nearest centroid instead (k DPs per
    query; ``search`` returns centroid indices and ``labels`` maps them
    to class labels). ``mode="sketch"`` serves through the sketch tier:
    matmul shortlist of ``top_c`` candidates, exact re-rank (skipped with
    ``approx=True``). Every mode records per-batch, per-stage wall-clock;
    ``stats()`` reports p50/p95/p99.

    ``refresh`` takes a ``core.snapshot.SnapshotStore``: before each batch
    the engine adopts the store's current snapshot if a learner published
    a newer one, so every query of a batch is answered by one fully built
    snapshot. ``stats()`` then reports the serving ``version`` and the
    refresh lag.

    ``monitor`` takes a fitted ``repro_torch.monitor.Monitor``: every
    batch is scored before it is served (anomaly decisions and the drift
    window), timed as its own ``monitor`` stage, and ``stats()`` gains the
    monitor's counters. The monitor keeps its own calibration engine, so
    a snapshot refresh never moves its threshold.

    ``device`` is where a fitted-here engine computes (default the CUDA
    card); an engine handed over keeps its own. ``shards > 1`` is the
    sharded tier of the multi-device slice, not ported yet.
    """

    def __init__(self, corpus, labels=None, *, kind: str = "spdtw",
                 sp: Optional[SparsePaths] = None, impl: str = "auto",
                 seed_k: int = 2, prefix_frac: float = 0.5,
                 centroid_model=None, mode: str = "cascade",
                 engine=None, sketch_r: int = 16, top_c: int = 32,
                 approx: bool = False, seed: int = 0, shards: int = 0,
                 refresh=None, monitor=None, device=None):
        if mode not in ("cascade", "centroid", "sketch"):
            raise ValueError(f"mode must be cascade, centroid or sketch, "
                             f"not {mode!r}")
        if shards > 1:
            raise NotImplementedError(
                "sharded serving (shards > 1) needs launch/shard_index.py "
                "and SimilarityEngine.shard, which come with the port's "
                "multi-device slice")
        if mode == "centroid" and centroid_model is None:
            raise ValueError("centroid mode needs a fitted "
                             "cluster.CentroidModel")
        if engine is None and refresh is not None:
            engine = refresh.current().engine
        if engine is None:
            spec = MeasureSpec(family=kind, seed=seed,
                               sketch_r=sketch_r if mode == "sketch" else 0)
            engine = fit(spec, corpus, labels=labels, sp=sp,
                         device=resolve_device(device))
        if mode == "sketch" and (engine.index is None or
                                 engine.index.sketch is None):
            raise ValueError("sketch mode needs an engine fit with "
                             "sketch_r > 0")
        if centroid_model is not None:
            engine = dataclasses.replace(engine,
                                         centroid_model=centroid_model)
        if monitor is not None and (monitor.engine.index is None or
                                    monitor.engine.index.sketch is None):
            raise ValueError("monitoring reads the sketch tier: fit the "
                             "monitor's engine with sketch_r > 0 "
                             "(repro_torch.monitor.fit_monitor)")
        self.mode = mode
        self.impl = impl
        self.seed_k = seed_k
        self.prefix_frac = prefix_frac
        self.top_c = top_c
        self.approx = approx
        self.store = refresh
        self.monitor = monitor
        self._bind_engine(engine)
        self.reset_stats()

    def _bind_engine(self, engine) -> None:
        """(Re)bind serving state to a fitted engine: the refresh seam.

        Everything queries read (index, centroid model, label map) is
        derived here from the one engine record, so adopting a snapshot
        between batches re-derives all of it at once."""
        self.engine = engine
        self.index = engine.index
        self.centroid_model = engine.centroid_model
        if self.mode == "centroid":
            # unsupervised models have labels=None: serve centroid ids
            self.labels = None if engine.centroid_model.labels is None \
                else np.asarray(engine.centroid_model.labels)
        else:
            self.labels = None if engine.labels is None else \
                np.asarray(engine.labels)

    def _maybe_refresh(self) -> None:
        """Adopt the store's current snapshot when a newer one was
        published (one wait-free read). The lag is recorded before the
        swap, so ``stats()`` reports the staleness queries saw."""
        if self.store is None:
            return
        snap = self.store.current()
        lag = int(snap.version) - int(self.engine.version)
        self._lag_sum += max(lag, 0)
        self._lag_max = max(self._lag_max, lag)
        self._lag_n += 1
        if lag > 0:
            self._bind_engine(snap.engine)
            self._n_refreshes += 1

    def reset_stats(self) -> None:
        """Zero every serving accumulator (prune counters, latency
        samples, pair and query totals, refresh lag), so each stream
        reports its own stats."""
        keys = _SKETCH_STAT_KEYS if self.mode == "sketch" else _STAT_KEYS
        self._stats_acc: Dict[str, float] = {k: 0.0 for k in keys}
        self._lat: Dict[str, List[float]] = {}
        self._pairs_total = 0
        self._pairs_dp = 0
        self._queries = 0
        self._n_refreshes = 0
        self._lag_sum = 0
        self._lag_max = 0
        self._lag_n = 0

    def _record_lat(self, stage: str, seconds: float) -> None:
        self._lat.setdefault(stage, []).append(seconds)

    @property
    def measure(self):
        """The ``Measure`` view of the fitted engine."""
        return self.engine.measure

    def search(self, queries) -> Tuple[np.ndarray, np.ndarray]:
        """(Nq, T) -> (nn_idx, nn_dist) as host numpy; prune stats
        accumulate on self.

        In centroid mode ``nn_idx`` indexes the centroid set (k DPs per
        query, counted as such in the pair stats)."""
        self._maybe_refresh()
        Q = self.engine._series(queries)
        n = int(Q.shape[0])
        if self.monitor is not None:
            # anomaly decisions and the drift window on this batch, timed
            # as their own stage (observe ends in a host sync)
            t_m = time.time()
            self.monitor.observe(Q, impl=self.impl)
            self._record_lat("monitor", time.time() - t_m)
        t0 = time.time()
        if self.mode == "centroid":
            from repro_torch.cluster import nearest_centroid
            idx, dist = nearest_centroid(Q, self.centroid_model,
                                         impl=self.impl)
            idx, dist = idx.cpu().numpy(), dist.cpu().numpy()
            self._record_lat("total", time.time() - t0)
            self._queries += n
            self._pairs_total += n * self.index.size
            self._pairs_dp += n * self.centroid_model.k
            return idx, dist
        if self.mode == "sketch":
            nn, dist, st = self.engine.knn(
                Q, impl=self.impl, mode="sketch", top_c=self.top_c,
                approx=self.approx, return_stats=True)
        else:
            nn, dist, st = self.engine.knn(
                Q, impl=self.impl, seed_k=self.seed_k,
                prefix_frac=self.prefix_frac, return_stats=True)
        # the host copy waits for this stream's work only, so the clock
        # is honest and a learner's stream is not waited on
        nn, dist = nn.cpu().numpy(), dist.cpu().numpy()
        self._record_lat("total", time.time() - t0)
        for stage in ("embed", "shortlist", "rerank"):
            if f"t_{stage}_s" in st:
                self._record_lat(stage, float(st[f"t_{stage}_s"]))
        for k in self._stats_acc:
            self._stats_acc[k] += float(st.get(k, 0.0)) * n
        self._queries += n
        self._pairs_total += n * self.index.size
        self._pairs_dp += int(st["dp_pairs"])
        return nn, dist

    def stats(self) -> Dict[str, float]:
        """Per-stage prune rates over everything served (cascade and
        sketch modes; centroid serving runs no bounds), plus per-stage
        p50/p95/p99 batch latency under ``latency_ms`` (sketch mode
        breaks out embed / shortlist / re-rank; every mode records the
        total)."""
        if self._queries == 0:
            return {}
        out: Dict[str, float] = {} if self.mode == "centroid" else \
            {k: v / self._queries for k, v in self._stats_acc.items()}
        out["pairs_dp"] = self._pairs_dp
        out["pre_dp_prune_overall"] = 1.0 - self._pairs_dp / max(
            self._pairs_total, 1)
        out["queries"] = self._queries
        out["pairs_total"] = self._pairs_total
        out["version"] = int(self.engine.version)
        if self.store is not None:
            out["refresh"] = {
                "published_version": int(self.store.version),
                "n_refreshes": self._n_refreshes,
                "mean_lag": self._lag_sum / max(self._lag_n, 1),
                "max_lag": int(self._lag_max)}
        if self.monitor is not None:
            out["monitor"] = self.monitor.counters()
        out["latency_ms"] = {stage: percentiles(v)
                             for stage, v in self._lat.items()}
        return out


def stream_search(engine: SearchEngine, queries: Sequence[np.ndarray],
                  batch: int = 16,
                  arrivals_per_step: Optional[int] = None
                  ) -> List[QueryResult]:
    """Serve a query stream with continuous batching.

    Requests arrive ``arrivals_per_step`` at a time (None = all up front)
    and join the pending queue; each step drains up to ``batch`` of them
    into one ``search`` call. A request admitted while a step is in flight
    waits for the next boundary.
    """
    if arrivals_per_step is not None and arrivals_per_step <= 0:
        raise ValueError("arrivals_per_step must be positive (or None for "
                         "all-up-front admission)")
    queries = list(queries)
    n = len(queries)
    pending: deque = deque()
    results: List[QueryResult] = []
    arrived = 0
    step = 0
    while arrived < n or pending:
        # admissions for this step boundary
        take = n - arrived if arrivals_per_step is None else min(
            arrivals_per_step, n - arrived)
        for _ in range(take):
            pending.append((arrived, step))
            arrived += 1
        if not pending:
            step += 1
            continue
        slot = [pending.popleft() for _ in range(min(batch, len(pending)))]
        Q = np.stack([np.asarray(queries[rid], np.float32)
                      for rid, _ in slot])
        nn, dist = engine.search(Q)
        for row, (rid, sub) in enumerate(slot):
            lab = None if engine.labels is None else int(
                engine.labels[nn[row]])
            results.append(QueryResult(rid=rid, nn=int(nn[row]),
                                       dist=float(dist[row]), label=lab,
                                       submitted_step=sub,
                                       completed_step=step))
        step += 1
    return sorted(results, key=lambda r: r.rid)


def _make_workload(ds, kind: str, n_queries: int, seed: int,
                   with_labels: bool = False):
    """Query stream: "classify" takes test-split series; "retrieval" takes
    warped and renoised corpus entries (the similarity-search case where
    the query has a close neighbour). ``with_labels`` also returns the
    per-query labels (classify only; None for retrieval). The same numpy
    draws as the reference's, so the two packages serve equal streams."""
    rng = np.random.default_rng(seed)
    if kind == "classify":
        reps = -(-n_queries // len(ds.X_test))
        Q = np.tile(ds.X_test, (reps, 1))[:n_queries]
        if with_labels:
            return Q, np.tile(ds.y_test, reps)[:n_queries]
        return Q
    T = ds.X_train.shape[1]
    src = rng.integers(0, len(ds.X_train), n_queries)
    out = np.empty((n_queries, T), np.float32)
    for i, s in enumerate(src):
        idx = np.sort(np.clip(np.arange(T) + rng.integers(-3, 4, T), 0, T - 1))
        q = ds.X_train[s][idx] + 0.1 * rng.normal(size=T)
        out[i] = (q - q.mean()) / (q.std() + 1e-8)
    return (out, None) if with_labels else out


def run(dataset: str = "CBF", workload: str = "retrieval",
        n_queries: int = 64, batch: int = 16, theta: float = 8.0,
        n_sp_train: int = 32, impl: str = "auto", seed: int = 0,
        arrivals_per_step: Optional[int] = None, check: bool = False,
        n_train: int = 128, centroids: int = 0, gamma: float = 0.1,
        fit_steps: int = 60, T: Optional[int] = None, sketch_r: int = 0,
        top_c: int = 32, approx: bool = False, shards: int = 0,
        device=None) -> dict:
    """Build an engine over a synthetic-UCR corpus and stream a query
    workload through it; returns throughput, prune rates, accuracy and
    latency percentiles. ``sketch_r > 0`` serves through the sketch tier
    with a ``top_c`` shortlist (``approx`` skips the re-rank). With
    ``check``, exactness against the full Gram is asserted: in sketch
    mode a full-coverage (top_c = corpus) pass must equal the Gram argmin
    and the served pass reports its recall instead."""
    from repro_torch.data import load
    dev = resolve_device(device)
    kw = {} if T is None else {"T": T}
    ds = load(dataset, n_train=n_train, **kw)
    Xtr = torch.as_tensor(ds.X_train, device=dev)
    sp = learn_sparse_paths(Xtr[:n_sp_train], theta=theta)
    model = None
    fit_s = 0.0
    if centroids > 0:
        from repro_torch.cluster import fit_class_centroids
        t0 = time.time()
        model = fit_class_centroids(Xtr, ds.y_train, sp.weights, gamma,
                                    n_per_class=centroids, steps=fit_steps,
                                    impl=impl)
        _sync(dev)
        fit_s = time.time() - t0
    mode = "sketch" if sketch_r > 0 else \
        ("centroid" if centroids > 0 else "cascade")
    engine = SearchEngine(Xtr, ds.y_train, sp=sp, impl=impl,
                          centroid_model=model, mode=mode, seed=seed,
                          sketch_r=sketch_r, top_c=top_c, approx=approx,
                          shards=shards, device=dev)
    queries, truth = _make_workload(ds, workload, n_queries, seed,
                                    with_labels=True)

    t0 = time.time()
    results = stream_search(engine, queries, batch=batch,
                            arrivals_per_step=arrivals_per_step)
    _sync(dev)
    dt = time.time() - t0

    out = {
        "dataset": dataset, "workload": workload, "backend": dev.type,
        "n_queries": len(results), "batch": batch,
        "corpus": engine.index.size, "theta": theta,
        "mode": engine.mode,
        "support_cells_frac": sp.n_cells / (ds.T * ds.T),
        "wall_s": dt, "queries_per_s": len(results) / dt,
        "mean_wait_steps": float(np.mean([r.wait_steps for r in results])),
        "stats": engine.stats(),
    }
    if model is not None:
        out["n_centroids"] = model.k
        out["centroid_fit_s"] = fit_s
    if workload == "classify":
        pred = np.array([r.label for r in results])
        out["accuracy"] = float(np.mean(pred == truth))
    if check:
        nn_got = np.array([r.nn for r in results])
        Q = torch.as_tensor(queries, device=dev)
        if engine.mode == "centroid":
            # nearest-centroid is exact over the centroid set
            Dc = model.distances(Q, impl=engine.impl).cpu().numpy()
            out["exact_match"] = bool((nn_got == Dc.argmin(1)).all())
            if not out["exact_match"]:
                raise AssertionError("engine diverged from brute-force "
                                     "nearest centroid")
        else:
            nn_true = engine.measure.cross(Q, Xtr, block=64) \
                .argmin(1).cpu().numpy()
            if engine.mode == "sketch":
                out["recall_at_1"] = float(np.mean(nn_got == nn_true))
                # covered exactness: a shortlist of the whole corpus must
                # equal the Gram argmin
                nn_full, _ = engine.engine.knn(Q, impl=engine.impl,
                                               mode="sketch",
                                               top_c=engine.index.size)
                nn_got = nn_full.cpu().numpy()
            out["exact_match"] = bool((nn_got == nn_true).all())
            if not out["exact_match"]:
                raise AssertionError("served neighbours diverged from the "
                                     "full-Gram 1-NN")
    return out


def main(argv=None):
    """CLI entry: ``python -m repro_torch.launch.search [--centroids N]
    [--sketch R] [--check] [--device cpu] ...``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="CBF")
    ap.add_argument("--workload", default="retrieval",
                    choices=("retrieval", "classify"))
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--theta", type=float, default=8.0)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--arrivals", type=int, default=None,
                    help="arrivals per step (default: all up front)")
    ap.add_argument("--check", action="store_true",
                    help="verify against the full-Gram path")
    ap.add_argument("--centroids", type=int, default=0,
                    help="serve nearest-centroid with N centroids per "
                         "class (0 = exact cascade)")
    ap.add_argument("--gamma", type=float, default=0.1,
                    help="soft-SP-DTW temperature for centroid fitting")
    ap.add_argument("--sketch", type=int, default=0, dest="sketch_r",
                    help="serve through the sketch tier with R anchors "
                         "(0 = exact cascade)")
    ap.add_argument("--top-c", type=int, default=32,
                    help="sketch shortlist size (the recall dial)")
    ap.add_argument("--approx", action="store_true",
                    help="skip the sketch re-rank (fastest, recall-bound)")
    ap.add_argument("--device", default=None,
                    help="where to compute (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.dataset, args.workload, args.queries, args.batch,
              theta=args.theta, impl=args.impl,
              arrivals_per_step=args.arrivals, check=args.check,
              centroids=args.centroids, gamma=args.gamma,
              sketch_r=args.sketch_r, top_c=args.top_c, approx=args.approx,
              device=args.device)
    print(json.dumps(out, indent=1, default=float))
    lat = out["stats"].get("latency_ms", {})
    for stage in ("embed", "shortlist", "rerank", "total"):
        if stage in lat:
            p = lat[stage]
            print(f"latency[{stage:9s}] p50={p['p50']:8.2f}ms "
                  f"p95={p['p95']:8.2f}ms p99={p['p99']:8.2f}ms")


if __name__ == "__main__":
    main()
