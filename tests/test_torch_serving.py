"""PyTorch port, the single-host serving tier on the CPU against the
reference: ``launch/stats``, ``core/snapshot``, ``launch/search``
(``SearchEngine`` in cascade, sketch and centroid mode, ``stream_search``,
``_make_workload``, ``run``) and the load shapes of ``launch/scenarios``.

Both sides get the same numpy inputs; the reference computes with
``impl="scan"``, the port with ``device="cpu"`` (its plain versions).
Neighbour ids, labels and stream bookkeeping must be equal, distances
within rtol = atol = 1e-5; sketch-mode engines draw the reference's
anchors (``torch_serving_helpers``). Timings differ by nature, so the
load shapes are compared on what the arrival process fixes.
"""
import dataclasses
import json
import re
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.check_artifacts import check_file
from repro.cluster import fit_class_centroids as j_centroids
from repro.core import SnapshotStore as JStore
from repro.core import learn_sparse_paths as j_learn
from repro.core.engine import fit as j_fit
from repro.core.spec import MeasureSpec as JSpec
from repro.data import load as j_load
from repro.launch import scenarios as j_sc
from repro.launch import search as j_search
from repro.launch.stats import percentiles as j_percentiles
from repro_torch.convert import centroid_model_from_reference
from repro_torch.core import EngineSnapshot, SnapshotStore
from repro_torch.core import learn_sparse_paths as t_learn
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.data import load as t_load
from repro_torch.launch import scenarios as t_sc
from repro_torch.launch import search as t_search
from repro_torch.launch.stats import PCTS, percentiles
from torch_serving_helpers import patch_reference_anchors

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _toy(T=32, n=20, nq=12, seed=0):
    rng = np.random.default_rng(seed)
    base = np.sin(np.linspace(0, 3 * np.pi, T))
    X = (base[None] + 0.3 * rng.normal(size=(n, T))).astype(np.float32)
    y = np.arange(n) % 3
    src = rng.integers(0, n, nq)
    Q = (X[src] + 0.05 * rng.normal(size=(nq, T))).astype(np.float32)
    return X, y, Q


# ------------------------------------------------------------------ stats
@pytest.mark.parametrize("samples", ([], [0.25], list(np.random.default_rng(
    0).exponential(0.01, size=101))), ids=("empty", "one", "many"))
def test_percentiles_equal_reference(samples):
    got = percentiles(samples)
    assert got == j_percentiles(samples)
    assert list(got) == [f"p{p}" for p in PCTS]


# ------------------------------------------------------------- snapshots
@pytest.fixture(scope="module")
def toy_engines():
    X, y, Q = _toy()
    jsp = j_learn(jnp.asarray(X[:10]), theta=2.0)
    tsp = t_learn(torch.as_tensor(X[:10]), theta=2.0)
    je = j_fit(JSpec("spdtw", seed=3), jnp.asarray(X), labels=y, sp=jsp,
               impl="scan")
    te = t_fit(TSpec("spdtw", seed=3), X, labels=y, sp=tsp, device="cpu")
    return X, y, Q, jsp, tsp, je, te


def test_snapshot_store_restamps_like_reference(toy_engines):
    """Every publication is restamped current + 1, whatever version the
    handed-in engine carries; versions and steps equal the reference's
    store on the same publication sequence."""
    *_, je, te = toy_engines
    got, want = SnapshotStore(te, keep_history=True), \
        JStore(je, keep_history=True)
    assert got.version == want.version == 0 and got.n_published == 0
    for step in (None, 7, None):
        a = got.publish(dataclasses.replace(te, version=99), step=step)
        b = want.publish(dataclasses.replace(je, version=99), step=step)
        assert (a.version, a.step) == (b.version, b.step)
        assert int(a.engine.version) == a.version
        assert got.current() is a
        assert isinstance(a, EngineSnapshot)
    assert got.n_published == want.n_published == 3
    assert [(s.version, s.step) for s in got.history] == \
        [(s.version, s.step) for s in want.history]
    assert got.current().corpus_size == te.corpus_size


def test_snapshot_store_current_is_wait_free_identity(toy_engines):
    te = toy_engines[-1]
    store = SnapshotStore(te)
    before = store.current()
    assert store.current() is before
    store.publish(te)
    assert before.version == 0 and store.current().version == 1
    assert store.history == []


def test_snapshot_store_concurrent_publishers_lose_no_version(toy_engines):
    """Eight writers publish at once, with a short interpreter switch
    interval, while a reader polls: every publication gets its own
    version, the history is 0..n without a gap, and the reader never sees
    the version go back."""
    te = toy_engines[-1]
    store = SnapshotStore(te, keep_history=True)
    n_writers, per = 8, 40
    seen = []
    done = threading.Event()

    def write():
        for _ in range(per):
            store.publish(te)

    def read():
        while not done.is_set():
            seen.append(store.current().version)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        writers = [threading.Thread(target=write) for _ in range(n_writers)]
        for w in writers:
            w.start()
        for w in writers:
            w.join(30)
        done.set()
        reader.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not reader.is_alive() and not any(w.is_alive() for w in writers)
    total = n_writers * per
    assert store.n_published == total and store.version == total
    assert [s.version for s in store.history] == list(range(total + 1))
    assert seen == sorted(seen)


# ------------------------------------------------------- workload streams
@pytest.mark.parametrize("kind", ("classify", "retrieval"))
def test_make_workload_equals_reference(kind):
    ds = t_load("CBF", n_train=12, n_test=9, T=24)
    dj = j_load("CBF", n_train=12, n_test=9, T=24)
    got = t_search._make_workload(ds, kind, 20, 5, with_labels=True)
    want = j_search._make_workload(dj, kind, 20, 5, with_labels=True)
    assert np.array_equal(got[0], want[0])
    if kind == "classify":
        assert np.array_equal(got[1], want[1])
    else:
        assert got[1] is None and want[1] is None


# ---------------------------------------------------------- SearchEngine
def _engines(mode, toy_engines, monkeypatch):
    X, y, Q, jsp, tsp, je, te = toy_engines
    if mode == "sketch":
        patch_reference_anchors(monkeypatch)
        js = j_search.SearchEngine(jnp.asarray(X), y, sp=jsp, impl="scan",
                                   mode="sketch", sketch_r=5, top_c=6,
                                   seed=3)
        ts = t_search.SearchEngine(X, y, sp=tsp, mode="sketch", sketch_r=5,
                                   top_c=6, seed=3, device="cpu")
        return js, ts
    model = None
    if mode == "centroid":
        jm = j_centroids(jnp.asarray(X), y, jsp.weights, 0.1, steps=3,
                         impl="scan")
        model = centroid_model_from_reference(jm, device="cpu")
        js = j_search.SearchEngine(None, engine=je, impl="scan",
                                   mode="centroid", centroid_model=jm)
    else:
        js = j_search.SearchEngine(None, engine=je, impl="scan")
    ts = t_search.SearchEngine(None, engine=te, mode=mode,
                               centroid_model=model)
    return js, ts


@pytest.mark.parametrize("mode", ("cascade", "sketch", "centroid"))
@pytest.mark.parametrize("arrivals", (None, 3))
def test_stream_search_matches_reference(mode, arrivals, toy_engines,
                                         monkeypatch):
    """Equal neighbours, labels and stream bookkeeping per query,
    distances within 1e-5, equal prune counters and pair counts."""
    Q = toy_engines[2]
    js, ts = _engines(mode, toy_engines, monkeypatch)
    want = j_search.stream_search(js, list(Q), batch=4,
                                  arrivals_per_step=arrivals)
    got = t_search.stream_search(ts, list(Q), batch=4,
                                 arrivals_per_step=arrivals)
    assert len(got) == len(want) == len(Q)
    for g, w in zip(got, want):
        assert (g.rid, g.nn, g.label, g.submitted_step,
                g.completed_step, g.wait_steps) == \
            (w.rid, w.nn, w.label, w.submitted_step, w.completed_step,
             w.wait_steps)
        np.testing.assert_allclose(g.dist, w.dist, **TOL)
    # counts equal; prune rates are the same fractions, which the
    # reference rounds to float32
    sg, sw = ts.stats(), js.stats()
    assert set(sg) == set(sw)
    for k in sw:
        if k == "latency_ms":
            assert set(sg[k]) == set(sw[k])
        elif isinstance(sg[k], int):
            assert sg[k] == sw[k], k
        else:
            np.testing.assert_allclose(sg[k], sw[k], rtol=1e-6,
                                       err_msg=k)
    ts.reset_stats()
    assert ts.stats() == {}


def test_search_returns_host_arrays_and_labels(toy_engines):
    X, y, Q, *_, te = toy_engines
    ts = t_search.SearchEngine(None, engine=te)
    nn, d = ts.search(Q[:5])
    assert isinstance(nn, np.ndarray) and isinstance(d, np.ndarray)
    enn, ed = te.knn(Q[:5])
    assert np.array_equal(nn, enn.numpy()) and np.array_equal(d, ed.numpy())
    assert np.array_equal(ts.labels, y)


def test_search_engine_refuses_what_it_cannot_serve(toy_engines):
    X, y, Q, jsp, tsp, je, te = toy_engines
    with pytest.raises(ValueError, match="cascade"):
        t_search.SearchEngine(None, engine=te, shards=2, mode="sketch")
    with pytest.raises(ValueError):
        t_search.SearchEngine(None, engine=te, mode="centroid")
    with pytest.raises(ValueError):
        t_search.SearchEngine(None, engine=te, mode="sketch")
    with pytest.raises(ValueError):
        t_search.SearchEngine(None, engine=te, mode="nearest")
    with pytest.raises(ValueError):
        t_search.stream_search(t_search.SearchEngine(None, engine=te),
                               list(Q), arrivals_per_step=0)


def test_entry_points_default_to_cuda(toy_engines):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    X, y = toy_engines[:2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_search.SearchEngine(X, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_search.run(n_queries=4, n_train=12, T=24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sc.refresh_run(n_queries=4, n_train=12, T=24)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_sc.anomaly_run(n_queries=4, n_train=12, T=24)


@pytest.mark.parametrize("mode", ("cascade", "classify", "centroids",
                                  "sketch"))
def test_search_run_matches_reference(mode, monkeypatch):
    """``run`` on the same synthetic corpus: the same stream, equal exact
    neighbours against the full Gram, equal accuracy and waits."""
    kw = dict(dataset="CBF", n_queries=8, batch=4, n_train=16, T=24,
              n_sp_train=8, seed=1, check=True, arrivals_per_step=4)
    if mode == "classify":
        kw["workload"] = "classify"
    if mode == "centroids":
        kw.update(workload="classify", centroids=1, fit_steps=2)
    if mode == "sketch":
        patch_reference_anchors(monkeypatch)
        kw.update(sketch_r=4, top_c=5)
    want = j_search.run(impl="scan", **kw)
    got = t_search.run(device="cpu", **kw)
    for k in ("n_queries", "batch", "corpus", "mode", "mean_wait_steps",
              "support_cells_frac", "exact_match"):
        assert got[k] == want[k], k
    assert got["exact_match"] is True
    if "accuracy" in want:
        assert got["accuracy"] == want["accuracy"]
    if mode == "sketch":
        assert got["recall_at_1"] == want["recall_at_1"]
    assert got["stats"]["pairs_dp"] == want["stats"]["pairs_dp"]


# ------------------------------------------------------------ load shapes
def test_load_shapes_serve_the_reference_stream(toy_engines):
    """offline, server (fixed rate, seeded arrivals) and single_stream:
    the same report keys as the reference, the arrival process's fixed
    numbers equal, every latency finite and ordered."""
    *_, Q, jsp, tsp, je, te = toy_engines
    ts = t_search.SearchEngine(None, engine=te)
    js = j_search.SearchEngine(None, engine=je, impl="scan")
    for name, fn, jfn, args in (
            ("offline", t_sc.offline_scenario, j_sc.offline_scenario,
             (Q, 4)),
            ("server", t_sc.server_scenario, j_sc.server_scenario, (Q, 4)),
            ("single_stream", t_sc.single_stream_scenario,
             j_sc.single_stream_scenario, (Q[:5],))):
        kw = {"rate_qps": 200.0} if name == "server" else {}
        got, want = fn(ts, *args, **kw), jfn(js, *args, **kw)
        assert set(got) == set(want), name
        for k in ("n_queries", "batch", "rate_qps", "seed"):
            if k in want:
                assert got[k] == want[k], (name, k)
        p = got["latency_ms"]
        assert 0.0 <= p["p50"] <= p["p95"] <= p["p99"]
        assert got["throughput_qps"] > 0
    # the server shape's per-batch hook sees every query once, in order
    rows = []
    t_sc.server_scenario(ts, Q, 4, rate_qps=200.0,
                         on_batch=lambda e, lo, take, nn, d:
                         rows.extend(range(lo, lo + take)))
    assert rows == list(range(len(Q)))


@pytest.fixture(scope="module")
def refresh_payload():
    return t_sc.refresh_run(dataset="CBF", n_queries=8, batch=4,
                            n_train=20, T=24, n_sp_train=10, seed=3,
                            learner_batch=3, rate_qps=500.0,
                            threaded=False, device="cpu")


# the reference's payload keys (launch/scenarios.py refresh_run)
REFRESH_KEYS = {
    "bench", "backend", "impl", "dataset", "T", "n_queries", "seed",
    "threaded", "corpus_initial", "corpus_final", "n_arrivals",
    "learner_batch", "n_snapshots", "final_version", "versions_monotone",
    "snapshot_cadence_s", "exact_final", "server", "server_refresh",
    "staleness"}


def test_refresh_run_payload(refresh_payload):
    """The reference's payload for the same split: 15 initial series, 5
    arrivals in mini-batches of 3 (two snapshots), every served query
    answered, the final snapshot equal to a fresh fit."""
    p = refresh_payload
    assert set(p) == REFRESH_KEYS and p["backend"] == "cpu"
    assert (p["corpus_initial"], p["n_arrivals"], p["corpus_final"]) == \
        (15, 5, 20)
    assert p["n_snapshots"] == p["final_version"] == 2
    assert p["exact_final"] is True and p["versions_monotone"] is True
    assert p["staleness"]["served_version"] == 2
    assert p["staleness"]["n_refreshes"] >= 1
    assert set(p["staleness"]) == {"published_version", "served_version",
                                   "n_refreshes", "mean_lag", "max_lag"}
    for key in ("server", "server_refresh"):
        assert p[key]["n_queries"] == 8 and p[key]["rate_qps"] == 500.0


def test_refresh_payload_passes_the_reference_schema(refresh_payload,
                                                     tmp_path):
    path = tmp_path / "BENCH_refresh.json"
    path.write_text(json.dumps(refresh_payload, default=float))
    assert check_file(str(path)) == []
    bad = dict(refresh_payload, exact_final=False)
    path.write_text(json.dumps(bad, default=float))
    assert any("from-scratch" in e for e in check_file(str(path)))


def test_scenarios_cli_writes_the_refresh_artifact(tmp_path):
    rc = t_sc.main(["--scenario", "server+refresh", "--smoke", "--device",
                    "cpu", "--out", str(tmp_path), "--rate", "500"])
    assert rc == 0
    assert check_file(str(tmp_path / "BENCH_refresh.json")) == []


# ------------------------------------------------------ the port stands alone
NEW_MODULES = ("repro_torch.launch.stats", "repro_torch.launch.search",
               "repro_torch.launch.learner", "repro_torch.launch.scenarios",
               "repro_torch.core.snapshot", "repro_torch.monitor",
               "repro_torch.monitor.anomaly", "repro_torch.monitor.drift",
               "repro_torch.monitor.embed", "repro_torch.launch.mesh",
               "repro_torch.launch.shard_index", "repro_torch.launch.gram",
               "repro_torch.launch.cluster")


def test_port_imports_neither_jax_nor_repro_nor_benchmarks():
    """No file of the port names jax, the reference package or the
    benchmarks in an import, and importing the serving tier loads none of
    them."""
    pat = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|repro|benchmarks)"
                     r"\b(?!_torch)", re.M)
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        assert not pat.search(path.read_text()), path
    code = ("import sys; sys.path.insert(0, 'src');"
            + "".join(f"import {m};" for m in NEW_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'benchmarks'));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
