"""MLPerf-style serving scenarios on one host: the measurement harness of
the serving tier.

Three load shapes with MLPerf-inference semantics, each measured with
wall-clock latency percentiles rather than a single mean:

  * **offline**: maximum throughput. All queries are available up
    front, sorted by series length so every batch is shape-uniform, then
    drained in full batches. Metric: throughput_qps.
  * **server**: seeded Poisson arrivals and continuous batching. The
    arrival process is drawn from ``MeasureSpec.seed``, the offered rate
    defaults to half the calibrated capacity, and each step drains every
    query that has arrived by the virtual clock (up to ``batch``), padded
    to the full batch. Metric: p50/p95/p99 of per-query latency =
    completion - arrival.
  * **single_stream**: one query in flight at a time (batch 1).

Two more shapes build on the server one:

  * **server+refresh** (``refresh_run``): the server scenario twice at
    the same offered rate, once against a frozen engine and once with a
    background ``Learner`` publishing versioned snapshots that serving
    adopts at batch boundaries (threaded: on its own CUDA stream). The
    payload (the reference's ``BENCH_refresh.json`` schema) reports both
    latency distributions, snapshot cadence, staleness, version
    monotonicity and ``exact_final``: the last snapshot answers as a
    fresh fit on the final corpus, bit for bit.
  * **anomaly** (``anomaly_run``): seeded outliers injected into the
    stream, the server scenario with the monitor off and on. The payload
    (``BENCH_anomaly.json`` schema, with the ``BENCH_embed.json`` map)
    reports the sketch-score ROC-AUC, the escalation rate, the p99
    overhead of monitoring, ``decisions_exact`` and the drift monitor on
    i.i.d. and shifted streams.

Every entry point computes on the CUDA card unless given
``device="cpu"``. The sharded ``run`` of the reference (the serving
payload over a sharded index) belongs to the multi-device slice.

  PYTHONPATH=src python -m repro_torch.launch.scenarios \\
      --scenario server+refresh --out /tmp/bench-refresh
  PYTHONPATH=src python -m repro_torch.launch.scenarios --smoke \\
      --scenario anomaly --device cpu --out /tmp/anomaly-smoke
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.occupancy import learn_sparse_paths
from repro_torch.launch.search import SearchEngine, _make_workload
from repro_torch.launch.stats import percentiles


def _drain(engine: SearchEngine, queries: np.ndarray,
           batch: int) -> np.ndarray:
    """Serve ``queries`` in back-to-back full batches; returns nn ids."""
    nn_all = []
    for lo in range(0, len(queries), batch):
        nn, _ = engine.search(queries[lo:lo + batch])
        nn_all.append(nn)
    return np.concatenate(nn_all)


def offline_scenario(engine: SearchEngine, queries: np.ndarray,
                     batch: int) -> Dict[str, float]:
    """Max-throughput drain: sorted-length batching, full batches,
    nothing waits on arrivals."""
    order = np.argsort([q.shape[-1] for q in queries], kind="stable")
    t0 = time.time()
    _drain(engine, queries[order], batch)
    wall = time.time() - t0
    return {"n_queries": len(queries), "batch": batch, "wall_s": wall,
            "throughput_qps": len(queries) / wall,
            "latency_ms": percentiles([wall / max(1, len(queries))] *
                                       len(queries))}


def server_scenario(engine: SearchEngine, queries: np.ndarray,
                    batch: int, *, rate_qps: Optional[float] = None,
                    seed: Optional[int] = None,
                    on_step: Optional[Callable[[int], None]] = None,
                    on_batch: Optional[Callable] = None
                    ) -> Dict[str, float]:
    """Poisson-arrival continuous batching with per-query latency.

    Arrivals are an exponential inter-arrival process seeded from the
    engine's ``MeasureSpec.seed`` (``seed`` overrides). One batch warms
    the engine (kernel builds and loads, allocator), then one measured
    batch gives the service capacity; ``rate_qps=None`` offers half of
    it. A virtual clock advances by each batch's measured service time;
    each step drains every query that has arrived by then (up to
    ``batch``, padded to ``batch`` rows), and a query's latency is its
    completion time minus its arrival time, queueing included.

    ``on_step(i)`` is called after each served batch (the hook the
    refresh shape uses to step a learner between batches);
    ``on_batch(engine, lo, take, nn, dist)`` gets each served batch's
    answers (rows ``lo:lo + take`` of ``queries``) for checking.
    """
    n = len(queries)
    if seed is None:
        seed = engine.engine.spec.seed
    rng = np.random.default_rng(seed)
    engine.search(queries[:batch])                   # warm
    t0 = time.time()
    engine.search(queries[:batch])                   # calibrate
    svc = time.time() - t0
    if rate_qps is None:
        rate_qps = 0.5 * batch / max(svc, 1e-9)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    now = 0.0
    served = 0
    lat: List[float] = []
    n_steps = 0
    while served < n:
        ready = int(np.searchsorted(arrivals, now, side="right"))
        if ready == served:            # idle: jump to the next arrival
            now = float(arrivals[served])
            continue
        take = min(batch, ready - served)
        # fixed-slot continuous batching: every step serves one
        # batch-sized block, so every step costs a full batch
        Qb = queries[served:served + take]
        if take < batch:
            Qb = np.concatenate(
                [Qb, np.broadcast_to(Qb[-1:], (batch - take,)
                                     + Qb.shape[1:])])
        t0 = time.time()
        nn, dist = engine.search(Qb)
        now += time.time() - t0
        if on_batch is not None:
            on_batch(engine, served, take, nn, dist)
        lat.extend(now - arrivals[served:served + take])
        served += take
        n_steps += 1
        if on_step is not None:
            on_step(n_steps)
    return {"n_queries": n, "batch": batch, "rate_qps": float(rate_qps),
            "seed": int(seed), "wall_s": float(now),
            "throughput_qps": n / max(now, 1e-9),
            "mean_batch": n / max(n_steps, 1),
            "latency_ms": percentiles(lat)}


def single_stream_scenario(engine: SearchEngine,
                           queries: np.ndarray) -> Dict[str, float]:
    """One query in flight at a time: sequential batch-1 serving, the
    per-query latency floor."""
    lat: List[float] = []
    t0 = time.time()
    for q in queries:
        t1 = time.time()
        engine.search(q[None])
        lat.append(time.time() - t1)
    wall = time.time() - t0
    return {"n_queries": len(queries), "batch": 1, "wall_s": wall,
            "throughput_qps": len(queries) / wall,
            "latency_ms": percentiles(lat)}


def refresh_run(dataset: str = "CBF", n_queries: int = 64,
                batch: int = 16, theta: float = 8.0, n_train: int = 128,
                T: Optional[int] = None, impl: str = "auto", seed: int = 0,
                rate_qps: Optional[float] = None, n_sp_train: int = 32,
                arrival_frac: float = 0.25, learner_batch: int = 8,
                threaded: bool = True, device=None,
                on_batch: Optional[Callable] = None) -> dict:
    """The ``server+refresh`` load shape: serving percentiles with and
    without a concurrent background learner.

    The training pool is split: the first ``1 - arrival_frac`` of it is
    the initially fitted corpus, the rest the learner's arrival stream
    (labels ride along). The server scenario runs twice at the same
    offered rate: first against the frozen initial engine (which
    calibrates the rate), then with a ``Learner`` publishing a snapshot
    per consumed mini-batch while serving adopts each one at the next
    batch boundary. ``threaded=True`` runs the learner in its own thread
    (on its own CUDA stream); ``threaded=False`` steps it between serving
    steps (deterministic). ``on_batch`` is passed to the second pass's
    ``server_scenario``.

    Returns the ``BENCH_refresh.json`` payload: both latency
    distributions, snapshot count and cadence, staleness (refresh lag),
    ``versions_monotone`` and ``exact_final`` (the last snapshot answers
    the queries as a fresh fit on the final corpus, bit for bit)."""
    from repro_torch.core.engine import fit
    from repro_torch.core.snapshot import SnapshotStore
    from repro_torch.data import load
    from repro_torch.launch.learner import Learner
    dev = resolve_device(device)
    kw = {} if T is None else {"T": T}
    ds = load(dataset, n_train=n_train, **kw)
    n_arr = max(1, int(len(ds.X_train) * arrival_frac))
    n0 = len(ds.X_train) - n_arr
    if n0 < 2:
        raise ValueError("arrival_frac leaves too small an initial corpus")
    X0, Xarr = ds.X_train[:n0], ds.X_train[n0:]
    y0, yarr = ds.y_train[:n0], ds.y_train[n0:]
    sp = learn_sparse_paths(torch.as_tensor(X0[:n_sp_train], device=dev),
                            theta=theta)
    queries = _make_workload(ds, "retrieval", n_queries, seed)

    # pass 1: frozen engine, the baseline (also calibrates the rate)
    base_engine = SearchEngine(X0, y0, sp=sp, impl=impl, seed=seed,
                               device=dev)
    base = server_scenario(base_engine, queries, batch, rate_qps=rate_qps,
                           seed=seed)

    # pass 2: the same initial engine behind a store, a learner refreshing
    store = SnapshotStore(base_engine.engine, keep_history=True)
    serve_engine = SearchEngine(None, refresh=store, impl=impl)
    learner = Learner(store, Xarr, labels=yarr, batch=learner_batch,
                      impl=impl)
    t0 = time.time()
    if threaded:
        learner.start()
        try:
            refreshed = server_scenario(serve_engine, queries, batch,
                                        rate_qps=base["rate_qps"],
                                        seed=seed, on_batch=on_batch)
        finally:
            learner.join()
    else:
        refreshed = server_scenario(
            serve_engine, queries, batch, rate_qps=base["rate_qps"],
            seed=seed, on_step=lambda i: learner.step(), on_batch=on_batch)
        learner.drain()
    learner_wall = time.time() - t0
    stats = serve_engine.stats()

    versions = [s.version for s in store.history]
    monotone = all(b == a + 1 for a, b in zip(versions, versions[1:]))

    # exactness of the final snapshot: equal answers to a fresh fit on the
    # final corpus (same sp / bsp / T)
    eng_f = store.current().engine
    fresh = fit(eng_f.spec, eng_f.corpus, labels=eng_f.labels,
                sp=eng_f.sp, bsp=eng_f.bsp, T=eng_f.T, device=dev)
    nn_a, d_a = eng_f.knn(queries, impl=impl)
    nn_b, d_b = fresh.knn(queries, impl=impl)
    exact_final = bool(torch.equal(nn_a, nn_b) and torch.equal(d_a, d_b))

    return {
        "bench": "refresh", "backend": dev.type,
        "impl": impl, "dataset": dataset, "T": int(ds.T),
        "n_queries": int(n_queries), "seed": int(seed),
        "threaded": bool(threaded),
        "corpus_initial": int(n0), "corpus_final": int(eng_f.corpus_size),
        "n_arrivals": int(n_arr), "learner_batch": int(learner_batch),
        "n_snapshots": int(store.n_published),
        "final_version": int(store.version),
        "versions_monotone": bool(monotone),
        "snapshot_cadence_s": learner_wall / max(store.n_published, 1),
        "exact_final": exact_final,
        "server": base, "server_refresh": refreshed,
        "staleness": {
            "published_version": int(store.version),
            "served_version": int(stats.get("version", 0)),
            "n_refreshes": int(stats["refresh"]["n_refreshes"]),
            "mean_lag": float(stats["refresh"]["mean_lag"]),
            "max_lag": int(stats["refresh"]["max_lag"]),
        },
    }


def _inject_outliers(queries: np.ndarray, frac: float,
                     seed: int) -> tuple:
    """Replace a seeded ``frac`` of the query stream with z-normalised
    random walks, off-manifold series no corpus family generates.
    Returns (queries, truth) with truth[i] = 1 on injected rows."""
    rng = np.random.default_rng([int(seed), 0xBAD5])
    q = np.array(queries, np.float32, copy=True)
    n, T = q.shape[0], q.shape[-1]
    n_out = max(1, int(round(frac * n)))
    idx = np.sort(rng.permutation(n)[:n_out])
    walks = np.cumsum(rng.normal(size=(n_out, T)), axis=1)
    walks = (walks - walks.mean(1, keepdims=True)) / \
        (walks.std(1, keepdims=True) + 1e-8)
    q[idx] = walks.astype(np.float32)
    truth = np.zeros(n, np.int32)
    truth[idx] = 1
    return q, truth


def anomaly_run(dataset: str = "CBF", n_queries: int = 96,
                batch: int = 16, theta: float = 8.0, n_train: int = 128,
                T: Optional[int] = None, impl: str = "auto", seed: int = 0,
                rate_qps: Optional[float] = None, n_sp_train: int = 32,
                outlier_frac: float = 0.25, sketch_r: int = 8,
                k: int = 3, quantile: float = 0.95, n_cal: int = 64,
                window: int = 24, alpha: float = 0.01,
                n_perm: int = 200, device=None) -> dict:
    """The ``anomaly`` load shape: the server scenario with a fitted
    ``repro_torch.monitor.Monitor`` scoring every batch, seeded outliers
    injected into the Poisson arrival stream.

    Four measurements make the ``BENCH_anomaly.json`` payload:

      * detection quality: the sketch-score ROC-AUC over the injected
        outliers, and ``decisions_exact`` (the escalated flag / clean
        decisions equal scoring every query with the exact cascade at
        the calibrated ``tau``);
      * serving cost: the server scenario at the same offered rate with
        the monitor off, then on; the p99 delta and ratio, and the
        monitored batches' per-stage latency (``stage_latency_ms``:
        ``monitor`` and ``total``, a key the reference's payload lacks);
      * escalation economy: the share of the stream that paid the exact
        cascade;
      * drift behaviour: a fresh ``DriftMonitor`` per stream stays silent
        on an i.i.d. resample of the corpus and fires on an
        amplitude-shifted copy of it.
    """
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data import load
    from repro_torch.monitor import (fit_drift_monitor, fit_monitor,
                                     roc_auc, sketch_map)
    dev = resolve_device(device)
    kw = {} if T is None else {"T": T}
    ds = load(dataset, n_train=n_train, **kw)
    Xtr = torch.as_tensor(ds.X_train, device=dev)
    sp = learn_sparse_paths(Xtr[:n_sp_train], theta=theta)
    spec = MeasureSpec("spdtw", theta=theta, seed=seed, sketch_r=sketch_r)
    eng = fit(spec, Xtr, labels=ds.y_train, sp=sp, device=dev)
    mon = fit_monitor(eng, k=k, quantile=quantile, n_cal=n_cal,
                      window=window, alpha=alpha, n_perm=n_perm, impl=impl)
    clean_q = _make_workload(ds, "retrieval", n_queries, seed)
    queries, truth = _inject_outliers(clean_q, outlier_frac, seed)

    # detection quality, off the serving clock: one batched decision pass
    # over the whole stream and the exact-cascade oracle
    flags, scores, dstats = mon.anomaly.decide(queries, impl=impl,
                                               return_stats=True)
    flags_x, _ = mon.anomaly.decide_exact(queries, impl=impl)
    decisions_exact = bool(np.array_equal(flags, flags_x))
    auc = roc_auc(scores, truth)

    # serving cost: same offered rate, monitor off then on
    off_engine = SearchEngine(None, engine=eng, impl=impl, seed=seed)
    base = server_scenario(off_engine, queries, batch, rate_qps=rate_qps,
                           seed=seed)
    mon.reset()
    on_engine = SearchEngine(None, engine=eng, impl=impl, seed=seed,
                             monitor=mon)
    monitored = server_scenario(on_engine, queries, batch,
                                rate_qps=base["rate_qps"], seed=seed)
    stats = on_engine.stats()
    p99_off = base["latency_ms"]["p99"]
    p99_on = monitored["latency_ms"]["p99"]

    # drift behaviour: fresh monitors, i.i.d. against amplitude-shifted
    rng = np.random.default_rng([int(seed), 0xD1FF])
    iid = np.asarray(ds.X_train)[rng.integers(0, len(ds.X_train),
                                              size=n_queries)]
    shifted = 2.0 * iid + 0.5
    dm_iid = fit_drift_monitor(eng, window=window, alpha=alpha,
                               n_perm=n_perm)
    dm_shift = fit_drift_monitor(eng, window=window, alpha=alpha,
                                 n_perm=n_perm)
    for lo in range(0, n_queries, batch):
        dm_iid.update(eng.sketch_embed(iid[lo:lo + batch], impl=impl))
        dm_shift.update(eng.sketch_embed(shifted[lo:lo + batch], impl=impl))

    return {
        "bench": "anomaly", "backend": dev.type,
        "impl": impl, "dataset": dataset, "T": int(ds.T),
        "corpus": int(eng.index.size), "n_queries": int(n_queries),
        "seed": int(seed), "theta": theta,
        "sketch_r": int(sketch_r), "k": int(k),
        "outlier_frac": float(outlier_frac),
        "n_outliers": int(truth.sum()),
        "quantile": float(quantile), "tau": float(mon.anomaly.tau),
        "roc_auc": float(auc),
        "decisions_exact": decisions_exact,
        "flag_rate": float(np.mean(flags)),
        "escalation_rate": float(dstats["escalation_rate"]),
        "n_escalated": int(dstats["n_escalated"]),
        "server": base, "server_monitor": monitored,
        "p99_overhead_ms": float(p99_on - p99_off),
        "p99_overhead_ratio": float(p99_on / max(p99_off, 1e-9)),
        "monitor": stats["monitor"],
        "stage_latency_ms": stats["latency_ms"],
        "drift": {
            "window": int(window), "alpha": float(alpha),
            "n_perm": int(n_perm),
            "events_iid": len(dm_iid.events),
            "events_shift": len(dm_shift.events),
            "silent_on_iid": len(dm_iid.events) == 0,
            "fires_on_shift": len(dm_shift.events) > 0,
        },
        "embed_map": sketch_map(eng),
    }


def _print_latency(name: str, sc: dict) -> None:
    p = sc["latency_ms"]
    print(f"{name:15s} {sc['throughput_qps']:9.1f} qps  "
          f"p50={p['p50']:8.2f}ms p95={p['p95']:8.2f}ms "
          f"p99={p['p99']:8.2f}ms")


def main(argv=None) -> int:
    """CLI entry: ``python -m repro_torch.launch.scenarios --scenario
    server+refresh|anomaly [--smoke] [--device cpu] [--out DIR]``: writes
    ``BENCH_refresh.json``, or ``BENCH_anomaly.json`` and
    ``BENCH_embed.json``, under ``--out`` (default: a fresh temporary
    directory) and exits nonzero when a gate of the payload fails."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", required=True,
                    choices=("server+refresh", "anomaly"))
    ap.add_argument("--dataset", default="CBF")
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--theta", type=float, default=8.0)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=None, dest="rate_qps",
                    help="server-scenario offered load in qps (default: "
                         "half the calibrated capacity)")
    ap.add_argument("--device", default=None,
                    help="where to compute (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes for a quick check")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default: a fresh temporary "
                         "directory)")
    args = ap.parse_args(argv)
    anomaly = args.scenario == "anomaly"
    kw = dict(dataset=args.dataset, n_queries=args.queries,
              batch=args.batch, theta=args.theta, impl=args.impl,
              seed=args.seed, rate_qps=args.rate_qps, device=args.device)
    if args.smoke:
        kw.update(n_queries=min(args.queries, 24), batch=min(args.batch, 8),
                  n_train=48, T=32, n_sp_train=16)
        kw.update(dict(sketch_r=4, n_cal=32, window=8, n_perm=100)
                  if anomaly else dict(learner_batch=4))
    out_dir = args.out
    if out_dir is None:
        import tempfile
        out_dir = tempfile.mkdtemp(prefix="bench-serving-")
    res = anomaly_run(**kw) if anomaly else refresh_run(**kw)
    res["smoke"] = bool(args.smoke)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "BENCH_anomaly.json" if anomaly
                        else "BENCH_refresh.json")
    if anomaly:
        # the dataset map is its own artifact
        emb = dict(res.pop("embed_map"), smoke=bool(args.smoke))
        with open(os.path.join(out_dir, "BENCH_embed.json"), "w") as f:
            json.dump(emb, f, indent=1, default=float)
            f.write("\n")
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=float)
        f.write("\n")
    print(json.dumps(res, indent=1, default=float))
    print(f"wrote {path}")
    if anomaly:
        _print_latency("server", res["server"])
        _print_latency("server+monitor", res["server_monitor"])
        print(f"roc_auc={res['roc_auc']:.3f} "
              f"escalation_rate={res['escalation_rate']:.3f} "
              f"p99_overhead={res['p99_overhead_ms']:+.2f}ms")
        if not res["decisions_exact"]:
            print("escalated anomaly decisions diverged from exact-cascade "
                  "scoring")
            return 1
        if not (res["drift"]["silent_on_iid"] and
                res["drift"]["fires_on_shift"]):
            print("drift monitor mis-triggered (fired on i.i.d. or stayed "
                  "silent on shift)")
            return 1
        return 0
    _print_latency("server", res["server"])
    _print_latency("server+refresh", res["server_refresh"])
    print(f"snapshots={res['n_snapshots']} "
          f"cadence={res['snapshot_cadence_s']:.3f}s "
          f"max_lag={res['staleness']['max_lag']}")
    if not (res["exact_final"] and res["versions_monotone"]):
        print("final snapshot diverged from a fresh fit, or versions were "
              "not monotone")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
