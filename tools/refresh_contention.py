"""Measure what a threaded learner costs the serving stream it runs beside.

The server load shape (``launch.scenarios.server_scenario``: seeded
Poisson arrivals at a fixed offered rate, continuous batches of 64) runs
against one snapshot store in three settings, at the refresh shape's full
width (UCR TwoPatterns, 750 initial series, 250 arrivals in mini-batches
of 25, 4000 retrieval queries, T = 128):

  frozen    no learner;
  counts    a threaded learner that accumulates the occupancy counts of
            every mini-batch (``support_every`` past the stream's last
            step, so the support is never re-learned: the reference's
            learner does this work on every step);
  default   the port's threaded learner, which skips counts no re-learn
            would read.

The offered rate is half the frozen engine's calibrated capacity and is
the same for every run. The learner settings alternate (counts, default,
default, counts) so drift in the card's clock falls on both. Each run
prints the queries' p50 / p95 / p99 latency, the throughput, the median
batch service time, the learner's time per snapshot (from its start to
its last publication, over the snapshots) and serving's
refresh counters (adoptions, lag); then the host ops (profiler events)
one learner step dispatches in each learner setting; the last line is
one JSON object of all of it.

Run from the repository root on a CUDA card:
    python3 tools/refresh_contention.py
``--device cpu`` (with ``--n-train 120 --n-queries 256``) runs it on the
CPU, where the times say nothing about the card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-train", type=int, default=1000)
    ap.add_argument("--n-queries", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--learner-batch", type=int, default=25)
    args = ap.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import SnapshotStore
    from repro_torch.core.engine import fit, resolve_device
    from repro_torch.core.occupancy import learn_sparse_paths
    from repro_torch.core.spec import MeasureSpec
    from repro_torch.data import load
    from repro_torch.launch.learner import Learner
    from repro_torch.launch.scenarios import server_scenario
    from repro_torch.launch.search import SearchEngine, _make_workload

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    ds = load("TwoPatterns", n_train=args.n_train, T=128)
    n0 = args.n_train - args.n_train // 4
    sp = learn_sparse_paths(torch.as_tensor(ds.X_train[:32], device=dev),
                            theta=8.0)
    base = fit(MeasureSpec("spdtw"), ds.X_train[:n0],
               labels=ds.y_train[:n0], sp=sp, device=dev)
    queries = _make_workload(ds, "retrieval", args.n_queries, 0)
    steps = -(-(args.n_train - n0) // args.learner_batch)

    frozen = SearchEngine(None, engine=base)
    ref = server_scenario(frozen, queries, args.batch)
    rate = ref["rate_qps"]
    runs = [dict(setting="frozen", **_summary(ref, frozen))]
    class TimedStore(SnapshotStore):
        """Records when each snapshot is published."""

        def publish(self, engine, **kw):
            snap = super().publish(engine, **kw)
            self.times.append(time.perf_counter())
            return snap

    for setting in ("counts", "default", "default", "counts"):
        store = TimedStore(base)
        store.times = []
        serve = SearchEngine(None, refresh=store)
        learner = Learner(store, ds.X_train[n0:], labels=ds.y_train[n0:],
                          batch=args.learner_batch,
                          support_every=steps + 1 if setting == "counts"
                          else None)
        t0 = time.perf_counter()
        learner.start()
        try:
            r = server_scenario(serve, queries, args.batch, rate_qps=rate)
        finally:
            learner.join()
        runs.append(dict(setting=setting,
                         learner_ms_per_snapshot=1e3 * (store.times[-1] - t0)
                         / steps,
                         refresh=serve.stats()["refresh"],
                         **_summary(r, serve)))
    for r in runs:
        p = r["latency_ms"]
        extra = "" if r["setting"] == "frozen" else (
            f", learner {r['learner_ms_per_snapshot']:.1f} ms per snapshot"
            f", refresh {r['refresh']}")
        print(f"{r['setting']:8s} p50 {p['p50']:.2f} / p95 {p['p95']:.2f} "
              f"/ p99 {p['p99']:.2f} ms, {r['throughput_qps']:.1f} "
              f"queries/s, batch service {r['service_ms']:.2f} ms{extra}")
    # host work of one learner step in each setting: the ops the step
    # dispatches while it holds the interpreter lock
    ops = {}
    for setting, every in (("counts", steps + 1), ("default", None)):
        lr = Learner(SnapshotStore(base), ds.X_train[n0:],
                     labels=ds.y_train[n0:], batch=args.learner_batch,
                     support_every=every)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            lr.step()
        ops[setting] = sum(e.count for e in prof.key_averages())
    print(f"host ops per learner step: counts {ops['counts']}, default "
          f"{ops['default']}")
    print(json.dumps({"rate_qps": rate, "runs": runs, "ops_per_step": ops}))
    return 0


def _summary(r, serve) -> dict:
    total = serve.stats()["latency_ms"]["total"]
    return {"latency_ms": r["latency_ms"],
            "throughput_qps": r["throughput_qps"],
            "service_ms": total["p50"]}


if __name__ == "__main__":
    sys.exit(main())
