"""PyTorch port, the measure layer on the CPU against the reference:
``SparsePaths.loc_list``, paper Algorithm 1 (``spdtw_loc``), ``Measure``
/ ``make_measure`` (visited cells, ``cross`` / ``gram_log`` / ``pair`` /
``logk``, the cascade index), ``SimilarityEngine.measure``, ``pairwise``
and ``dedup_by_spdtw``.

Tolerances: LOC lists, visited cells, neighbours and kept indices equal;
Algorithm 1 equal to the reference's (the same float64 loop) and within
rtol 1e-5 of the port's dense DP; values within rtol / atol 1e-5 of the
reference's (exp / log differ in the last bits between XLA and
PyTorch), the DTW_sc Gram bit for bit (both sides run the dense core
DP).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import learn_sparse_paths as j_learn
from repro.core.engine import fit as j_fit
from repro.core.measures import ALL_MEASURES as J_ALL
from repro.core.measures import make_measure as j_make
from repro.core.measures import pairwise as j_pairwise
from repro.core.spdtw import spdtw_loc as j_loc
from repro.core.spec import MeasureSpec as JSpec
from repro.data import load
from repro.data.pipeline import dedup_by_spdtw as j_dedup
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.measures import ALL_MEASURES, make_measure, pairwise
from repro_torch.core.occupancy import learn_sparse_paths as t_learn
from repro_torch.core.spdtw import spdtw, spdtw_loc, spdtw_pairwise
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.data.pipeline import dedup_by_spdtw
from repro_torch.kernels import launch_counts

TOL = dict(rtol=1e-5, atol=1e-5)
NAMES = ALL_MEASURES + ("krdtw_sc",)
PARAMS = dict(radius=3, nu=0.5, lags=5)


@pytest.fixture(scope="module")
def ds():
    return load("CBF", n_train=16, n_test=12, T=24)


@pytest.fixture(scope="module")
def sps(ds):
    j = j_learn(jnp.asarray(ds.X_train), theta=2.0, gamma=0.5)
    t = t_learn(torch.as_tensor(ds.X_train), theta=2.0, gamma=0.5)
    return j, t


def _measures(name, ds, sps):
    T = ds.T
    jsp, tsp = sps if name in ("spdtw", "sp_krdtw") else (None, None)
    return (j_make(name, T, sp=jsp, **PARAMS),
            make_measure(name, T, sp=tsp, device="cpu", **PARAMS))


def test_all_measures_and_loc_list_equal_reference(sps):
    assert ALL_MEASURES == J_ALL
    jsp, tsp = sps
    for got, want in zip(tsp.loc_list(), jsp.loc_list()):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def test_spdtw_loc_equals_reference_and_dense_dp(ds, sps):
    jsp, tsp = sps
    rows, cols, w = tsp.loc_list()
    for i in range(4):
        x, y = ds.X_test[i], ds.X_train[i]
        got = spdtw_loc(x, y, rows, cols, w)
        assert got == j_loc(x, y, rows, cols, w)
        np.testing.assert_allclose(got, float(spdtw(x, y, tsp)), rtol=1e-5)
    # a support cut in two (row 5 removed) leaves no path: both report
    # the "no path" sentinel
    w = tsp.weights.clone()
    w[5, :] = 0.0
    cut = dataclasses.replace(tsp, weights=w, support=w > 0)
    r2, c2, w2 = cut.loc_list()
    x, y = ds.X_test[0], ds.X_train[0]
    assert spdtw_loc(x, y, r2, c2, w2) >= 1e29
    assert float(spdtw(x, y, cut)) >= 1e29


@pytest.mark.parametrize("name", NAMES)
def test_visited_cells_equal_reference(name, ds, sps):
    jm, tm = _measures(name, ds, sps)
    assert tm.visited_cells == jm.visited_cells
    assert tm.is_kernel == jm.is_kernel
    assert tm.supports_cascade == jm.supports_cascade


@pytest.mark.parametrize("name", NAMES)
def test_cross_gram_log_pair_logk_match_reference(name, ds, sps):
    before = launch_counts()
    jm, tm = _measures(name, ds, sps)
    A, B = ds.X_test, ds.X_train
    jc = np.asarray(jm.cross(jnp.asarray(A), jnp.asarray(B)))
    tc = tm.cross(A, B)
    assert tc.device.type == "cpu" and tuple(tc.shape) == jc.shape
    if name == "dtw_sc":
        assert np.array_equal(tc.numpy(), jc)
    else:
        np.testing.assert_allclose(tc.numpy(), jc, **TOL)
    assert np.array_equal(tc.argmin(1).numpy(), jc.argmin(1))
    y = B[np.arange(len(A)) % len(B)]
    jp = np.asarray(jax.vmap(jm.pair)(jnp.asarray(A), jnp.asarray(y)))
    np.testing.assert_allclose(tm.pair(A, y).numpy(), jp, **TOL)
    np.testing.assert_allclose(float(tm.pair(A[0], y[0])), jp[0], **TOL)
    if tm.is_kernel:
        jg = np.asarray(jm.gram_log(jnp.asarray(A), jnp.asarray(B)))
        np.testing.assert_allclose(tm.gram_log(A, B).numpy(), jg, **TOL)
        # the self-similarities of a split, one batched call
        jd = np.asarray([float(jm.logk_fn(jnp.asarray(x), jnp.asarray(x)))
                         for x in A])
        np.testing.assert_allclose(tm.logk_fn(A, A).numpy(), jd, **TOL)
    else:
        assert tm.logk_fn is None
        with pytest.raises(ValueError):
            tm.gram_log(A, B)
    assert launch_counts() == before


@pytest.mark.parametrize("name", ("dtw", "spdtw"))
def test_measure_knn_and_index_match_reference(name, ds, sps):
    jm, tm = _measures(name, ds, sps)
    jnn, jd = jm.knn(jnp.asarray(ds.X_test), jnp.asarray(ds.X_train))
    nn, d = tm.knn(ds.X_test, ds.X_train)
    assert np.array_equal(nn.numpy(), np.asarray(jnn))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    idx = tm.build_index(ds.X_train)
    assert tm.build_index(ds.X_train) is idx        # cached on content
    assert np.array_equal(tm.bsp.plan(), jm.bsp.plan())


def test_engine_measure_is_the_engine_view(ds):
    spec = dict(theta=2.0, weight_gamma=0.5, radius=3, nu=0.5)
    je = j_fit(JSpec("spdtw", **spec), jnp.asarray(ds.X_train))
    te = t_fit(TSpec("spdtw", **spec), ds.X_train, device="cpu")
    m = te.measure
    assert m.device.type == "cpu" and m.name == "spdtw"
    assert m.visited_cells == je.measure.visited_cells == te.sp.n_cells
    np.testing.assert_allclose(m.cross(ds.X_test, ds.X_train).numpy(),
                               te.gram(ds.X_test).numpy(), **TOL)
    for fam in ("dtw", "dtw_sc", "euclidean", "krdtw_sc"):
        sup = "band" if fam == "dtw_sc" else "dense"
        e = t_fit(TSpec(fam, support=sup, **spec), ds.X_train,
                  device="cpu")
        j = j_fit(JSpec(fam, support=sup, **spec), jnp.asarray(ds.X_train))
        assert e.measure.visited_cells == j.measure.visited_cells


def test_pairwise_and_spdtw_pairwise_match_reference(ds, sps):
    jsp, tsp = sps
    A, B = ds.X_test, ds.X_train
    np.testing.assert_allclose(
        spdtw_pairwise(A, B, tsp.weights, device="cpu").numpy(),
        np.asarray(j_pairwise(jnp.asarray(A), jnp.asarray(B), "spdtw",
                              weights=jsp.weights)), **TOL)
    for kind in ("dtw", "krdtw", "sp_krdtw"):
        got = pairwise(A, B, kind, sp=tsp, nu=0.5, device="cpu")
        want = np.asarray(j_pairwise(jnp.asarray(A), jnp.asarray(B), kind,
                                     sp=jsp, nu=0.5))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError):
        pairwise(A, B, "euclidean", device="cpu")


@pytest.mark.parametrize("threshold", (5.0, 20.0))
def test_dedup_by_spdtw_keeps_the_reference_indices(threshold):
    d = load("SyntheticControl", n_train=30, n_test=6, T=32)
    rng = np.random.default_rng(4)
    # near-duplicates: jittered copies of the first 10 series
    X = np.concatenate([d.X_train, d.X_train[:10] +
                        0.05 * rng.normal(size=(10, 32))]).astype(np.float32)
    jx, jidx = j_dedup(X, threshold, sample_for_grid=12, seed=3)
    tx, tidx = dedup_by_spdtw(X, threshold, sample_for_grid=12, seed=3,
                              device="cpu")
    assert np.array_equal(tidx, jidx)
    assert np.array_equal(tx, np.asarray(jx))
    assert len(tidx) < len(X)
