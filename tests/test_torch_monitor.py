"""PyTorch port, the monitor tier on the CPU against the reference:
``monitor/anomaly`` (``decide`` equal to ``decide_exact`` bit for bit,
flags equal to the reference's, ``tau`` within rtol 1e-5), ``monitor/drift``
(thresholds within rtol 1e-5, the same trigger positions),
``monitor/embed`` (PCA and the dataset map), ``Monitor`` riding a
``SearchEngine``, and the anomaly load shape's payload.

Every port engine here draws the reference's anchors
(``torch_serving_helpers``), so both packages score the same sketch; the
reference computes with ``impl="scan"``, the port with ``device="cpu"``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.check_artifacts import check_file
from repro import monitor as jm
from repro.core import learn_sparse_paths as j_learn
from repro.core.engine import fit as j_fit
from repro.core.spec import MeasureSpec as JSpec
from repro.launch import scenarios as j_sc
from repro.launch.search import SearchEngine as JSearch
from repro_torch import monitor as tm
from repro_torch.core import learn_sparse_paths as t_learn
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.launch import scenarios as t_sc
from repro_torch.launch.search import SearchEngine as TSearch
from torch_serving_helpers import patch_reference_anchors


def _toy(T=40, n=28, seed=0, labels=True):
    """Sinusoid-family corpus (the reference test's)."""
    rng = np.random.default_rng(seed)
    base = np.sin(np.linspace(0, 3 * np.pi, T))
    X = (base[None] + 0.3 * rng.normal(size=(n, T))).astype(np.float32)
    y = (np.arange(n) % 3) if labels else None
    return X, y


def _stream(X, nq=18, n_out=5, seed=1):
    """Jittered corpus entries with the first ``n_out`` rows replaced by
    z-normalised random walks. Returns (queries, truth)."""
    rng = np.random.default_rng(seed)
    n, T = X.shape
    Q = X[rng.integers(0, n, nq)] + \
        0.05 * rng.normal(size=(nq, T)).astype(np.float32)
    walks = np.cumsum(rng.normal(size=(n_out, T)), axis=1)
    walks = (walks - walks.mean(1, keepdims=True)) / \
        (walks.std(1, keepdims=True) + 1e-8)
    Q[:n_out] = walks
    truth = np.zeros(nq, np.int32)
    truth[:n_out] = 1
    return Q.astype(np.float32), truth


def _score_tol(te) -> dict:
    """Sketch scores are ||f||^2 + ||s||^2 - 2 f.s over features that
    agree within rel 1e-6, so they agree within 1e-6 of the squared-norm
    scale the expansion cancels from, not of the (small) score."""
    return dict(rtol=1e-5, atol=1e-6 * float(te.index.sketch.sq.max()))


def _pair(monkeypatch, seed=0, sketch_r=6, labels=True):
    """The reference engine and the port's on the same corpus, support
    and anchors."""
    patch_reference_anchors(monkeypatch)
    X, y = _toy(seed=seed, labels=labels)
    jsp = j_learn(jnp.asarray(X[:16]), theta=1.0)
    tsp = t_learn(torch.as_tensor(X[:16]), theta=1.0)
    je = j_fit(JSpec("spdtw", theta=1.0, seed=seed, sketch_r=sketch_r), X,
               labels=y, sp=jsp, impl="scan")
    te = t_fit(TSpec("spdtw", theta=1.0, seed=seed, sketch_r=sketch_r), X,
               labels=y, sp=tsp, device="cpu")
    np.testing.assert_allclose(te.index.sketch.sketch.numpy(),
                               np.asarray(je.index.sketch.sketch),
                               rtol=1e-6)
    return X, je, te


# ------------------------------------------------------------- anomaly
def test_anomaly_decisions_equal_exact_and_reference(monkeypatch):
    X, je, te = _pair(monkeypatch)
    js = jm.fit_anomaly_scorer(je, k=3, quantile=0.8, n_cal=20,
                               impl="scan")
    ts = tm.fit_anomaly_scorer(te, k=3, quantile=0.8, n_cal=20)
    np.testing.assert_allclose(ts.tau, js.tau, rtol=1e-5)
    np.testing.assert_allclose(ts.cal_dists, js.cal_dists, rtol=1e-5)
    np.testing.assert_allclose(ts.cal_scores, js.cal_scores,
                               **_score_tol(te))
    Q, truth = _stream(X)
    flags, scores, st = ts.decide(Q, return_stats=True)
    flags_x, d_exact = ts.decide_exact(Q)
    assert flags.dtype == bool and np.array_equal(flags, flags_x)
    assert np.array_equal(flags_x, d_exact > np.float32(ts.tau))
    jflags, jscores, jst = js.decide(Q, impl="scan", return_stats=True)
    assert np.array_equal(flags, jflags)
    assert st == jst
    np.testing.assert_allclose(scores, jscores, **_score_tol(te))
    assert flags[truth == 1].all()
    assert st["n_clean_fast"] + st["n_flag_fast"] + st["n_escalated"] \
        == len(Q)
    assert tm.roc_auc(scores, truth) >= 0.9
    # precomputed features take the same path
    f2, s2 = ts.decide(Q, feats=te.sketch_embed(Q))
    assert np.array_equal(f2, flags) and np.array_equal(s2, scores)


def test_anomaly_scorer_seeded_and_deterministic(monkeypatch):
    X, je, te = _pair(monkeypatch, seed=3)
    s1 = tm.fit_anomaly_scorer(te, k=2, quantile=0.9, n_cal=16)
    s2 = tm.fit_anomaly_scorer(te, k=2, quantile=0.9, n_cal=16)
    assert s1.tau == s2.tau
    assert np.array_equal(s1.cal_dists, s2.cal_dists)
    assert s1.tau == float(np.quantile(s1.cal_dists, 0.9))
    Q, _ = _stream(X, nq=8, n_out=2)
    f1, sc1 = s1.decide(Q)
    jsc = jm.fit_anomaly_scorer(je, k=2, quantile=0.9, n_cal=16,
                                impl="scan")
    np.testing.assert_allclose(s1.calibrated(sc1), jsc.calibrated(sc1))
    np.testing.assert_allclose(s1.score(Q), jsc.score(Q, impl="scan"),
                               **_score_tol(te))
    cal = s1.calibrated(sc1)
    assert ((0.0 <= cal) & (cal <= 1.0)).all()
    assert (np.diff(cal[np.argsort(sc1)]) >= 0).all()


def test_monitors_require_a_sketch():
    X, _ = _toy()
    plain = t_fit(TSpec("spdtw", theta=1.0), X,
                  sp=t_learn(torch.as_tensor(X[:12]), theta=1.0),
                  device="cpu")
    for fn in (tm.fit_anomaly_scorer, tm.fit_drift_monitor, tm.fit_monitor,
               tm.sketch_map):
        with pytest.raises(ValueError):
            fn(plain)
    with pytest.raises(ValueError):
        TSearch(None, engine=plain, monitor=tm.Monitor(engine=plain))


@pytest.mark.parametrize("scores, labels", (
    ([1, 2, 3, 10, 11], [0, 0, 0, 1, 1]),
    ([1, 2, 10, 11, 12], [1, 1, 0, 0, 0]),
    ([5, 5, 5, 5], [0, 1, 0, 1]),
    (list(np.random.default_rng(0).normal(size=40)),
     list(np.random.default_rng(1).integers(0, 2, 40))),
))
def test_roc_auc_equals_reference(scores, labels):
    assert tm.roc_auc(scores, labels) == jm.roc_auc(scores, labels)


def test_roc_auc_needs_both_classes():
    with pytest.raises(ValueError):
        tm.roc_auc([1, 2], [1, 1])


# ---------------------------------------------------------------- drift
def test_drift_thresholds_and_triggers_equal_reference(monkeypatch):
    """Thresholds within rtol 1e-5 of the reference's and the same
    trigger positions: silent on an i.i.d. resample, firing on an
    amplitude shift."""
    X, je, te = _pair(monkeypatch, seed=5)
    rng = np.random.default_rng(7)
    iid = X[rng.integers(0, len(X), 32)]
    shifted = 2.0 * iid + 0.5

    def drive(fit_dm, eng, stream, embed):
        dm = fit_dm(eng, window=8, alpha=0.01, n_perm=100)
        for lo in range(0, len(stream), 8):
            dm.update(embed(eng, stream[lo:lo + 8]))
        return dm

    def t_embed(e, x):
        return e.sketch_embed(x)

    def j_embed(e, x):
        return np.asarray(e.sketch_embed(x, impl="scan"))

    for stream in (iid, shifted):
        got = drive(tm.fit_drift_monitor, te, stream, t_embed)
        want = drive(jm.fit_drift_monitor, je, stream, j_embed)
        assert got.thresholds.keys() == want.thresholds.keys()
        for k in want.thresholds:
            np.testing.assert_allclose(got.thresholds[k],
                                       want.thresholds[k], rtol=1e-5)
        assert got.events == want.events
        assert (got.n_seen, got.n_windows) == (want.n_seen, want.n_windows)
    assert drive(tm.fit_drift_monitor, te, iid, t_embed).events == []
    assert len(drive(tm.fit_drift_monitor, te, shifted, t_embed).events) \
        >= 1


def test_drift_monitor_state_machine(monkeypatch):
    X, _, te = _pair(monkeypatch)
    dm = tm.fit_drift_monitor(te, window=6, alpha=0.05, n_perm=50)
    feats = te.sketch_embed(X[:4])
    assert dm.update(feats) is False
    assert dm.n_seen == 4 and dm.n_windows == 0
    dm.update(feats)
    assert dm.n_windows == 1 and dm.last_stats is not None
    c = dm.counters()
    assert c["n_seen"] == 8 and c["window"] == 6
    assert set(c["thresholds"]) == {"mean_shift", "quantile_shift"}
    dm.reset()
    assert dm.n_seen == 0 and dm.events == [] and dm.last_stats is None
    with pytest.raises(ValueError):
        dm.update(feats[:, :2])


# ------------------------------------------------------------ embedding
def test_power_iteration_pca_equals_reference():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(40, 7)) @ np.diag([3.0, 2.0, 1.0, .5, .3, .2, .1])
    got = tm.power_iteration_pca(M, 3, seed=0)
    want = jm.power_iteration_pca(M, 3, seed=0)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    # a tensor input gives the same axes
    for g, w in zip(tm.power_iteration_pca(torch.as_tensor(M), 3, seed=0),
                    want):
        assert np.array_equal(g, w)


def test_sketch_map_matches_reference(monkeypatch):
    X, je, te = _pair(monkeypatch)
    got, want = tm.sketch_map(te), jm.sketch_map(je)
    assert set(got) == set(want)
    for k in ("n_series", "R", "n_components", "seed", "coords_truncated"):
        assert got[k] == want[k], k
    assert got["orthonormal_err"] <= 1e-6
    np.testing.assert_allclose(got["explained_var"], want["explained_var"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["coords"], want["coords"], rtol=1e-4,
                               atol=1e-4)
    assert [(c["label"], c["n"]) for c in got["classes"]] == \
        [(c["label"], c["n"]) for c in want["classes"]]
    m2 = tm.sketch_map(te, max_points=10)
    assert len(m2["coords"]) == 10 and m2["coords_truncated"]


# ------------------------------------------------- serving-side integration
def test_monitor_rides_search_engine_like_reference(monkeypatch):
    X, je, te = _pair(monkeypatch)
    kw = dict(k=3, quantile=0.8, n_cal=16, window=8, alpha=0.01, n_perm=100)
    tmon = tm.fit_monitor(te, **kw)
    jmon = jm.fit_monitor(je, impl="scan", **kw)
    ts = TSearch(None, engine=te, monitor=tmon)
    js = JSearch(None, engine=je, monitor=jmon, impl="scan")
    Q, truth = _stream(X, nq=16, n_out=4)
    for lo in range(0, 16, 8):
        nn, d = ts.search(Q[lo:lo + 8])
        jnn, jd = js.search(Q[lo:lo + 8])
        assert np.array_equal(nn, jnn)
    got, want = ts.stats()["monitor"], js.stats()["monitor"]
    assert set(got) == set(want)
    for k in ("n_batches", "n_scored", "n_flagged", "n_escalated",
              "escalation_rate"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-5)
    assert got["drift"]["events"] == want["drift"]["events"]
    assert got["n_flagged"] >= int(truth.sum())
    p = ts.stats()["latency_ms"]["monitor"]
    assert 0.0 <= p["p50"] <= p["p95"] <= p["p99"]
    # serving answers are untouched by monitoring
    nn_m, d_m = ts.search(Q)
    nn_p, d_p = TSearch(None, engine=te).search(Q)
    assert np.array_equal(nn_m, nn_p) and np.array_equal(d_m, d_p)
    tmon.reset()
    assert tmon.n_scored == 0 and tmon.drift.n_seen == 0


# ------------------------------------------------------ the anomaly shape
def test_anomaly_run_matches_reference_and_schema(monkeypatch, tmp_path):
    """The anomaly load shape on the same corpus, stream and anchors:
    equal decisions, escalations and drift events, ``tau`` within rtol
    1e-5; both artifacts pass the reference's schema gate, which still
    rejects a failing payload."""
    patch_reference_anchors(monkeypatch)
    kw = dict(n_queries=6, batch=6, n_train=24, T=32, n_sp_train=12,
              sketch_r=4, n_cal=16, window=6, alpha=0.01, n_perm=100,
              seed=0)
    out = t_sc.anomaly_run(device="cpu", **kw)
    want = j_sc.anomaly_run(impl="scan", **kw)
    assert set(out) == set(want) | {"stage_latency_ms"}
    assert set(out["stage_latency_ms"]) == {"monitor", "total"}
    for k in ("corpus", "n_outliers", "decisions_exact", "flag_rate",
              "escalation_rate", "n_escalated", "roc_auc"):
        assert out[k] == want[k], k
    np.testing.assert_allclose(out["tau"], want["tau"], rtol=1e-5)
    for k in ("events_iid", "events_shift", "silent_on_iid",
              "fires_on_shift"):
        assert out["drift"][k] == want["drift"][k], k
    assert out["decisions_exact"] is True and out["roc_auc"] >= 0.9
    assert out["monitor"]["n_scored"] >= out["n_queries"]
    emb = out.pop("embed_map")
    a_path, e_path = tmp_path / "BENCH_anomaly.json", \
        tmp_path / "BENCH_embed.json"
    a_path.write_text(json.dumps(out, default=float))
    e_path.write_text(json.dumps(emb, default=float))
    assert check_file(str(a_path)) == []
    assert check_file(str(e_path)) == []
    bad = dict(out, roc_auc=0.5, decisions_exact=False)
    (tmp_path / "bad").mkdir()
    bad_path = tmp_path / "bad" / "BENCH_anomaly.json"
    bad_path.write_text(json.dumps(bad, default=float))
    errs = check_file(str(bad_path))
    assert any("ROC-AUC" in e for e in errs)
    assert any("bit-identical" in e for e in errs)
