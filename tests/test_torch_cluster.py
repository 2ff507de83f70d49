"""PyTorch port, the centroid path: ``train.optimizer.AdamW``,
``cluster`` (soft barycenters, k-means, class centroids),
``classify.centroid`` and the centroid-seeded cascade (stage 0 of
``ops._knn_cascade``) against the reference on the same numpy inputs, on
the CPU.

Limits: AdamW steps rtol 1e-6 (XLA's float32 pow of the bias correction
is not PyTorch's; measured max difference 4e-9 after 20 steps).
Barycenter loss histories rtol 1e-5; centroids atol 5e-4 after 10 Adam
steps (measured 8e-5: Adam divides each gradient by its own running
RMS, so f32 roundoff in near-zero gradient entries shows at the step
size). Assignments, medoids, labels, predictions and neighbours equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.classify import centroid as j_cc
from repro.cluster import barycenter as j_bc
from repro.cluster import kmeans as j_km
from repro.core.engine import fit as j_fit
from repro.core.spec import MeasureSpec as JSpec
from repro.data.synthetic_ucr import make_two_patterns
from repro.train.optimizer import AdamW as JAdamW
from repro_torch.classify import centroid as t_cc
from repro_torch.cluster import barycenter as t_bc
from repro_torch.cluster import kmeans as t_km
from repro_torch.convert import (centroid_model_from_reference,
                                 engine_from_reference)
from repro_torch.kernels import _build
from repro_torch.train import AdamW as TAdamW

T = 24


@pytest.fixture(scope="module")
def engines():
    """A reference spdtw engine on TwoPatterns (24 train, 12 test, T =
    24, tile 8) and the port's copy of it, with reference centroids."""
    ds = make_two_patterns(n_train=24, n_test=12, T=T)
    je = j_fit(JSpec("spdtw", theta=2.0, weight_gamma=0.5, tile=8),
               ds.X_train, labels=ds.y_train)
    te = engine_from_reference(je, device="cpu")
    jc = je.fit_centroids(1, steps=4)
    return ds, je, te, jc


@pytest.fixture
def launches_unchanged():
    before = _build.launch_counts()
    yield
    assert _build.launch_counts() == before, "a CPU tensor launched a kernel"


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_steps_equal_reference(wd):
    rng = np.random.default_rng(0)
    p = rng.normal(size=(2, 17)).astype(np.float32)
    ja, ta = JAdamW(lr=0.05, weight_decay=wd), TAdamW(lr=0.05,
                                                     weight_decay=wd)
    jp, tp = jnp.asarray(p), torch.as_tensor(p)
    js, ts = ja.init(jp), ta.init(tp)
    for _ in range(20):
        g = rng.normal(size=p.shape).astype(np.float32)
        jp, js = ja.update(jnp.asarray(g), js, jp)
        tp, ts = ta.update(torch.as_tensor(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                                   atol=0)
    assert ts.step == int(js.step) == 20
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-6)


def test_soft_barycenter_matches_reference(engines, launches_unchanged):
    ds, je, te, _ = engines
    X = ds.X_train[ds.y_train == 0]
    w = np.asarray(je.weights)
    sw = (np.arange(len(X)) % 3 != 0).astype(np.float32)
    for kw in ({}, {"sample_weights": sw}):
        jz, jl = j_bc.soft_barycenter(jnp.asarray(X), jnp.asarray(w), 0.1,
                                      steps=10, **{k: jnp.asarray(v)
                                                   for k, v in kw.items()})
        tz, tl = t_bc.soft_barycenter(torch.as_tensor(X), te.weights, 0.1,
                                      steps=10, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=5e-4)
        assert float(tl[-1]) < float(tl[0])


def test_class_centroids_equal_reference(engines, launches_unchanged):
    ds, je, te, jc = engines
    tc = te.fit_centroids(1, steps=4)
    jm, tm = jc.centroid_model, tc.centroid_model
    assert np.array_equal(tm.labels, np.asarray(jm.labels))
    assert np.array_equal(tm.medoids, np.asarray(jm.medoids))
    np.testing.assert_allclose(tm.centroids.numpy(),
                               np.asarray(jm.centroids), atol=5e-4)
    # nearest-centroid prediction on the same centroids
    tmr = centroid_model_from_reference(jm, device="cpu")
    assert np.array_equal(
        t_cc.nearest_centroid_predict(torch.as_tensor(ds.X_test),
                                      tmr).numpy(),
        np.asarray(j_cc.nearest_centroid_predict(jnp.asarray(ds.X_test),
                                                 jm)))
    assert t_cc.centroid_error_series(ds.X_test, ds.y_test, tmr) == \
        pytest.approx(j_cc.centroid_error_series(ds.X_test, ds.y_test, jm))


def test_soft_kmeans_equals_reference(engines, launches_unchanged):
    ds, je, te, _ = engines
    X = ds.X_train[:12]
    w = np.asarray(je.weights)
    jm, ji = j_km.soft_kmeans(jnp.asarray(X), 3, jnp.asarray(w), 0.1,
                              iters=2, steps=3, seed=5)
    tm, ti = t_km.soft_kmeans(torch.as_tensor(X), 3, te.weights, 0.1,
                              iters=2, steps=3, seed=5, bsp=te.bsp)
    assert np.array_equal(ti["assign"], np.asarray(ji["assign"]))
    assert np.array_equal(tm.medoids, np.asarray(jm.medoids))
    np.testing.assert_allclose(ti["inertia"], ji["inertia"], rtol=1e-5)
    np.testing.assert_allclose(tm.centroids.numpy(),
                               np.asarray(jm.centroids), atol=5e-4)


def test_within_class_kmeans_centroids_equal_reference(engines,
                                                       launches_unchanged):
    ds, je, te, _ = engines
    w = np.asarray(je.weights)
    # four members of each of two classes: one member-set shape, so the
    # reference compiles its step loop once
    idx = np.concatenate([np.nonzero(ds.y_train == c)[0][:4] for c in (0, 1)])
    X, y = ds.X_train[idx], ds.y_train[idx]
    jm = j_km.fit_class_centroids(jnp.asarray(X), y, jnp.asarray(w), 0.1,
                                  n_per_class=2, steps=2, kmeans_iters=1,
                                  seed=3)
    tm = t_km.fit_class_centroids(torch.as_tensor(X), y, te.weights, 0.1,
                                  n_per_class=2, steps=2, kmeans_iters=1,
                                  seed=3, bsp=te.bsp)
    assert np.array_equal(tm.labels, np.asarray(jm.labels))
    assert np.array_equal(tm.medoids, np.asarray(jm.medoids))


def test_centroid_seeded_cascade_is_exact(engines, launches_unchanged):
    ds, je, te, jc = engines
    tce = dataclasses.replace(
        te, centroid_model=centroid_model_from_reference(jc.centroid_model,
                                                         device="cpu"))
    Q = torch.as_tensor(ds.X_test)
    nn, nnd, stats = tce.knn(Q, return_stats=True)
    nn0, nnd0 = te.knn(Q)
    G = te.gram(Q)
    assert torch.equal(nn, nn0) and torch.equal(nnd, nnd0)
    assert torch.equal(nn, torch.argmin(G, dim=1).to(torch.int32))
    jnn, _, jstats = jc.knn(ds.X_test, return_stats=True)
    assert np.array_equal(nn.numpy(), np.asarray(jnn))
    assert stats["n_centroids"] == jstats["n_centroids"] == 4
    for k in ("dp_pairs", "seed_k", "prefix_tiles", "plan_tiles"):
        assert stats[k] == jstats[k], k
    for k in ("stage1_prune", "stage2_prune", "stage3_prune",
              "pre_dp_prune", "dp_abandoned"):
        assert stats[k] == pytest.approx(float(jstats[k]), abs=1e-6), k
    # classify routes to nearest-centroid when a model was fit
    assert np.array_equal(tce.classify(Q), np.asarray(jc.classify(
        ds.X_test)))
    assert np.array_equal(tce.classify(Q, via="knn"),
                          ds.y_train[nn.numpy()])
    with pytest.raises(ValueError):
        te.classify(Q, via="centroid")


def test_fit_with_centroids_and_soft_methods(engines, launches_unchanged):
    from repro_torch.core.engine import fit
    ds, je, te, _ = engines
    eng = fit(te.spec, ds.X_train, labels=ds.y_train, sp=te.sp, bsp=te.bsp,
              device="cpu", centroids=1, centroid_steps=2)
    assert eng.centroid_model is not None and eng.centroid_model.k == 4
    x = torch.as_tensor(ds.X_test[:3])
    y = torch.as_tensor(ds.X_train[:3])
    val, gx = eng.grad(x, y)
    want = np.asarray(je.soft_pairs(ds.X_test[:3], ds.X_train[:3]))
    np.testing.assert_allclose(val.numpy(), want, rtol=1e-5)
    _, jgx = je.grad(ds.X_test[:3], ds.X_train[:3])
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgx).max()))
    G = eng.soft_gram(x)
    np.testing.assert_allclose(
        G.numpy(), np.asarray(je.soft_gram(ds.X_test[:3])), rtol=1e-5)
