"""PyTorch port, the learner/actor split on the CPU against the reference:
``launch/learner.Learner`` and its snapshot sequence, the snapshot
consistency of serving under refresh, and the threaded learner.

The reference's world (``tests/test_learner.py``): a 14-series corpus,
8 arrivals in mini-batches of 4, T = 24, 6 queries. Both packages get the
same numpy inputs; the port must publish the reference's snapshot
sequence (versions, steps, corpora, labels, supports and plans equal,
envelopes within 1e-6, answers: neighbours equal, distances within
rtol = atol = 1e-5), with the support re-learned on the same steps under
``support_every`` and under a drift trigger (reference anchors patched
in). The port's own contracts are held on its own sequence: every query
served during a refresh equals the answer of the snapshot that served
it, at every swap point and under a real thread.
"""
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import fit_class_centroids as j_centroids
from repro.cluster.barycenter import soft_barycenter as j_bary
from repro.core import SnapshotStore as JStore
from repro.core import learn_sparse_paths as j_learn
from repro.core.engine import fit as j_fit
from repro.core.spec import MeasureSpec as JSpec
from repro.launch.learner import Learner as JLearner
from repro.launch.search import SearchEngine as JSearch
from repro.monitor import fit_drift_monitor as j_drift
from repro_torch.convert import centroid_model_from_reference
from repro_torch.core import SnapshotStore
from repro_torch.core import learn_sparse_paths as t_learn
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.launch.learner import Learner
from repro_torch.launch.search import SearchEngine
from repro_torch.monitor import fit_drift_monitor as t_drift
from torch_serving_helpers import patch_reference_anchors

_N0, _NA, _T, _LB, _NQ = 14, 8, 24, 4, 6     # corpus/arrivals/len/batch/queries
TOL = dict(rtol=1e-5, atol=1e-5)


def _knn(engine, Q):
    nn, d = engine.knn(Q)
    return nn.numpy(), d.numpy()


def _data(seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(_N0 + _NA, _T)).astype(np.float32)
    Q = rng.normal(size=(_NQ, _T)).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def world():
    """The reference's snapshot sequence and the port's, from the same
    corpus, support and arrival stream, with each snapshot's answers."""
    X, Q = _data()
    jsp = j_learn(jnp.asarray(X[:8]), theta=6.0)
    tsp = t_learn(torch.as_tensor(X[:8]), theta=6.0)
    jbase = j_fit(JSpec("spdtw", seed=3), jnp.asarray(X[:_N0]), sp=jsp,
                  impl="scan")
    base = t_fit(TSpec("spdtw", seed=3), X[:_N0], sp=tsp, device="cpu")
    jstore = JStore(jbase, keep_history=True)
    JLearner(jstore, X[_N0:], batch=_LB, impl="scan").drain()
    store = SnapshotStore(base, keep_history=True)
    Learner(store, X[_N0:], batch=_LB).drain()
    answers = {s.version: _knn(s.engine, Q) for s in store.history}
    return dict(X=X, Q=Q, base=base, history=store.history,
                jhistory=jstore.history, answers=answers)


def _same_snapshots(got, want, Q):
    """Snapshot sequences equal: versions, steps, corpora, labels,
    support, plan, envelopes, answers."""
    assert [(s.version, s.step) for s in got] == \
        [(s.version, s.step) for s in want]
    for g, w in zip(got, want):
        ge, we = g.engine, w.engine
        assert np.array_equal(ge.corpus.numpy(), np.asarray(we.corpus))
        if we.labels is None:
            assert ge.labels is None
        else:
            assert np.array_equal(ge.labels, np.asarray(we.labels))
        assert np.array_equal(ge.sp.support.numpy(),
                              np.asarray(we.sp.support))
        np.testing.assert_allclose(ge.weights.numpy(),
                                   np.asarray(we.weights), rtol=1e-6)
        assert np.array_equal(ge.bsp.active, np.asarray(we.bsp.active))
        for f in ("env_lo", "env_hi"):
            np.testing.assert_allclose(getattr(ge.index, f).numpy(),
                                       np.asarray(getattr(we.index, f)),
                                       rtol=1e-6, atol=1e-6)
        nn, d = _knn(ge, Q)
        jnn, jd = we.knn(jnp.asarray(Q), impl="scan")
        assert np.array_equal(nn, np.asarray(jnn))
        np.testing.assert_allclose(d, np.asarray(jd), **TOL)


# ------------------------------------------------- the reference's sequence
def test_learner_snapshot_sequence_equals_reference(world):
    _same_snapshots(world["history"], world["jhistory"], world["Q"])


def test_learner_is_deterministic_and_takes_tensor_arrivals(world):
    """Replaying the stream (given as a tensor this time) reproduces the
    port's sequence bit for bit."""
    X = world["X"]
    store = SnapshotStore(world["base"], keep_history=True)
    Learner(store, torch.as_tensor(X[_N0:]), batch=_LB).drain()
    for got, want in zip(store.history, world["history"]):
        ia, ib = got.engine.index, want.engine.index
        for f in ("corpus", "env_lo", "env_hi"):
            assert torch.equal(getattr(ia, f), getattr(ib, f))


def test_learner_versions_monotone_and_exhaustion(world):
    assert [s.version for s in world["history"]] == \
        list(range(1 + -(-_NA // _LB)))
    lr = Learner(SnapshotStore(world["base"]), world["X"][_N0:], batch=_LB)
    assert lr.pending == _NA
    lr.drain(max_steps=1)
    assert lr.pending == _NA - _LB and not lr.exhausted
    lr.drain()
    assert lr.exhausted and lr.pending == 0
    assert lr.step() is None


def test_learner_refuses_bad_streams(world):
    X, base = world["X"], world["base"]
    store = SnapshotStore(base)
    with pytest.raises(ValueError):
        Learner(store, X[_N0:], labels=np.zeros(3), batch=_LB)
    with pytest.raises(ValueError):
        Learner(store, X[_N0:], batch=0)
    labelled = SnapshotStore(t_fit(TSpec("spdtw", seed=3), X[:_N0],
                                   labels=np.arange(_N0) % 2,
                                   sp=base.sp, device="cpu"))
    with pytest.raises(ValueError):
        Learner(labelled, X[_N0:], batch=_LB)


@pytest.mark.parametrize("labelled", (False, True))
def test_support_every_relearns_like_reference(world, labelled):
    """``support_every=1``: the support is re-learned from the combined
    counts on every step, on both sides alike (labels riding along)."""
    X, Q = world["X"], world["Q"]
    y = np.arange(len(X)) % 3 if labelled else None
    jsp = j_learn(jnp.asarray(X[:8]), theta=6.0)
    tsp = t_learn(torch.as_tensor(X[:8]), theta=6.0)
    jbase = j_fit(JSpec("spdtw", seed=3), jnp.asarray(X[:_N0]),
                  labels=None if y is None else y[:_N0], sp=jsp,
                  impl="scan")
    base = t_fit(TSpec("spdtw", seed=3), X[:_N0],
                 labels=None if y is None else y[:_N0], sp=tsp,
                 device="cpu")
    arr_y = None if y is None else y[_N0:]
    jstore, store = JStore(jbase, keep_history=True), \
        SnapshotStore(base, keep_history=True)
    jl = JLearner(jstore, X[_N0:], labels=arr_y, batch=_LB,
                  support_every=1, impl="scan")
    tl = Learner(store, X[_N0:], labels=arr_y, batch=_LB, support_every=1)
    jl.drain()
    tl.drain()
    assert tl.n_support_refreshes == jl.n_support_refreshes == 2
    np.testing.assert_allclose(tl._counts.numpy(), np.asarray(jl._counts))
    _same_snapshots(store.history, jstore.history, Q)


def test_drift_triggered_relearn_like_reference(monkeypatch):
    """A learner given a drift monitor re-learns the support on the steps
    the trigger fires, as the reference's does; an i.i.d. stream leaves
    the support alone."""
    patch_reference_anchors(monkeypatch)
    rng = np.random.default_rng(0)
    T, n = 40, 28
    base = np.sin(np.linspace(0, 3 * np.pi, T))
    X = (base[None] + 0.3 * rng.normal(size=(n, T))).astype(np.float32)
    jsp = j_learn(jnp.asarray(X[:16]), theta=1.0)
    tsp = t_learn(torch.as_tensor(X[:16]), theta=1.0)
    je = j_fit(JSpec("spdtw", theta=1.0, seed=0, sketch_r=6), X, sp=jsp,
               impl="scan")
    te = t_fit(TSpec("spdtw", theta=1.0, seed=0, sketch_r=6), X, sp=tsp,
               device="cpu")
    rng = np.random.default_rng(11)
    iid = X[rng.integers(0, len(X), 8)]
    shifted = (2.0 * iid + 0.5).astype(np.float32)
    for arrivals, fires in ((iid, False), (shifted, True)):
        jstore = JStore(je, keep_history=True)
        jl = JLearner(jstore, arrivals, batch=8,
                      drift_monitor=j_drift(je, window=8, n_perm=100),
                      impl="scan")
        jl.drain()
        store = SnapshotStore(te, keep_history=True)
        tl = Learner(store, arrivals, batch=8,
                     drift_monitor=t_drift(te, window=8, n_perm=100))
        tl.drain()
        assert tl.n_support_refreshes == jl.n_support_refreshes
        assert (tl.n_support_refreshes >= 1) is fires
        assert tl.drift.events == jl.drift.events
        w_new = store.current().engine.weights.numpy()
        assert np.array_equal(w_new, te.weights.numpy()) is not fires
        if fires:
            _same_snapshots(store.history, jstore.history, arrivals[:6])


def test_centroid_refresh_matches_reference(world):
    """Labelled arrivals refresh each class centroid by warm-started Adam
    steps over its members (K8 / K9 on the card). The reference's
    ``Learner`` cannot run this step under jax 0.9.0 (it writes into a
    read-only ``np.asarray`` view of a jax array; ROADMAP section C), so
    the reference's refresh is replayed here with its own
    ``soft_barycenter``; the refreshed centroids stay within the
    barycenter's known difference (at most 8e-5 after 10 steps)."""
    X, Q = world["X"], world["Q"]
    y = np.arange(len(X)) % 2
    jsp = j_learn(jnp.asarray(X[:8]), theta=6.0)
    tsp = t_learn(torch.as_tensor(X[:8]), theta=6.0)
    jmodel = j_centroids(jnp.asarray(X[:_N0]), y[:_N0], jsp.weights, 0.1,
                         steps=2, impl="scan")
    base = dataclasses.replace(
        t_fit(TSpec("spdtw", seed=3), X[:_N0], labels=y[:_N0], sp=tsp,
              device="cpu"),
        centroid_model=centroid_model_from_reference(jmodel, device="cpu"))
    store = SnapshotStore(base, keep_history=True)
    Learner(store, X[_N0:], labels=y[_N0:], batch=_LB,
            centroid_steps=3).drain()
    # the reference's refresh: per step, each centroid over the arrivals
    # of its label
    Z = np.array(jmodel.centroids)
    want = [Z.copy()]
    mlab = np.asarray(jmodel.labels)
    for lo in range(_N0, len(X), _LB):
        xb, yb = X[lo:lo + _LB], y[lo:lo + _LB]
        for c in range(len(Z)):
            members = xb[yb == mlab[c]]
            if len(members):
                zc, _ = j_bary(jnp.asarray(members), jmodel.weights,
                               jmodel.gamma, init=jnp.asarray(Z[c]),
                               steps=3, lr=0.05)
                Z[c] = np.asarray(zc)
        want.append(Z.copy())
    assert len(store.history) == len(want)
    for snap, w in zip(store.history, want):
        m = snap.engine.centroid_model
        np.testing.assert_allclose(m.centroids.numpy(), w, atol=1e-4)
        assert np.array_equal(m.medoids, np.asarray(jmodel.medoids))
    first, last = store.history[0].engine, store.history[-1].engine
    assert not torch.equal(first.centroid_model.centroids,
                           last.centroid_model.centroids)
    # a centroid-seeded cascade answers as the unseeded one
    nn, d = _knn(last, Q)
    nn0, d0 = _knn(dataclasses.replace(last, centroid_model=None), Q)
    assert np.array_equal(nn, nn0) and np.array_equal(d, d0)


# --------------------------------------- every swap point, refresh lag
def test_every_swap_point_answers_equal_their_snapshot(world):
    """The query stream is served one query at a time while the two
    learner steps are injected before positions (i, j) for every
    0 <= i <= j < n_queries: each answer equals the precomputed answer of
    the snapshot that served it, and the served versions never go
    back."""
    X, Q, answers = world["X"], world["Q"], world["answers"]
    for i in range(_NQ):
        for j in range(i, _NQ):
            store = SnapshotStore(world["base"])
            serve = SearchEngine(None, refresh=store)
            lr = Learner(store, X[_N0:], batch=_LB)
            served = []
            for q in range(_NQ):
                if q == i:
                    lr.step()
                if q == j:
                    lr.step()
                nn, d = serve.search(Q[q:q + 1])
                v = int(serve.engine.version)
                served.append(v)
                assert nn[0] == answers[v][0][q], (i, j, q, v)
                assert d[0] == answers[v][1][q], (i, j, q, v)
            assert served == sorted(served), (i, j)
            assert served[-1] == store.version


def test_refresh_lag_counters_equal_reference(world):
    """Two publications between batches show as lag 2 on the next batch,
    then serving catches up; the counters equal the reference's."""
    X, Q = world["X"], world["Q"]
    stats = []
    for Store, Search, Learn, base, kw in (
            (SnapshotStore, SearchEngine, Learner, world["base"], {}),
            (JStore, JSearch, JLearner, world["jhistory"][0].engine,
             {"impl": "scan"})):
        store = Store(base)
        serve = Search(None, refresh=store, **kw)
        lr = Learn(store, X[_N0:], batch=_LB, **kw)
        serve.search(Q[:2])
        lr.step()
        lr.step()
        serve.search(Q[:2])
        st = serve.stats()
        serve.reset_stats()
        serve.search(Q[:2])
        stats.append((st["version"], st["refresh"], serve.stats()["refresh"]))
    got, want = stats
    assert got == want
    assert got[0] == 2 and got[1]["max_lag"] == 2
    assert got[1]["n_refreshes"] == 1 and got[2]["max_lag"] == 0


# ------------------------------------------------------------- threaded
def test_threaded_learner_answers_match_some_snapshot(world):
    """With the learner running in its own thread (a short switch
    interval to interleave it with serving), every query served equals
    the precomputed answer of the snapshot that served it, and the
    thread publishes the reference's version sequence."""
    X, Q, answers = world["X"], world["Q"], world["answers"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            store = SnapshotStore(world["base"], keep_history=True)
            serve = SearchEngine(None, refresh=store)
            lr = Learner(store, X[_N0:], batch=_LB)
            lr.start(interval_s=0.002)
            try:
                for q in range(_NQ):
                    nn, d = serve.search(Q[q:q + 1])
                    v = int(serve.engine.version)
                    assert nn[0] == answers[v][0][q]
                    assert d[0] == answers[v][1][q]
                lr.join(timeout=60)
            finally:
                lr.stop()
            assert lr.exhausted
            assert [s.version for s in store.history] == \
                [s.version for s in world["history"]]
    finally:
        sys.setswitchinterval(old)


def test_learner_thread_failure_is_raised(world, monkeypatch):
    """A step that raises in the thread is not lost: ``join`` raises
    it, and a second ``start`` is refused while a thread runs."""
    lr = Learner(SnapshotStore(world["base"]), world["X"][_N0:], batch=_LB)

    def boom():
        raise FloatingPointError("step failed")

    monkeypatch.setattr(lr, "step", boom)
    lr.start()
    with pytest.raises(RuntimeError, match="learner thread failed") as e:
        lr.join(timeout=30)
    assert isinstance(e.value.__cause__, FloatingPointError)
    lr.stop()                         # already joined: nothing left to raise
    lr2 = Learner(SnapshotStore(world["base"]), world["X"][_N0:], batch=_LB)
    lr2.start(interval_s=0.05)
    try:
        with pytest.raises(RuntimeError, match="already started"):
            lr2.start()
    finally:
        lr2.stop()
