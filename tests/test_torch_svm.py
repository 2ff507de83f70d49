"""PyTorch port, kernel-measure engine and classify layer on the CPU
against the reference: ``fit`` for every newly fitted family (pairs /
gram / knn), the log-semiring kernel cascade, the kernel SVM and
meta-parameter selection, and a kernel engine carried across by
``convert``.

Tolerances: kernel and baseline values within rtol/atol 1e-5 (exp / log
differ in the last bits between XLA and PyTorch), the DTW_sc values
bit for bit (both sides run the dense core DP); SVM alphas within atol
1e-4 (float32 matrix products summed in another order over 500 steps);
neighbours, cascade statistics, predicted labels, errors and selected
meta-parameters equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.classify.crossval  # noqa: F401  (registers the submodules)
import repro.classify.svm  # noqa: F401
import sys
from repro.core import learn_sparse_paths as j_learn
from repro.core import pairwise_path_counts as j_counts
from repro.core.engine import fit as j_fit
from repro.core.spec import MeasureSpec as JSpec
from repro.data import load
from repro_torch.classify import crossval as t_cv
from repro_torch.classify import svm as t_svm
from repro_torch.convert import engine_from_reference
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.occupancy import pairwise_path_counts as t_counts
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.kernels import launch_counts, ops

j_svm = sys.modules["repro.classify.svm"]
j_cv = sys.modules["repro.classify.crossval"]
TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = {
    "krdtw": dict(support="dense", nu=0.5),
    "krdtw_sc": dict(support="dense", nu=0.5, radius=3),
    "sp_krdtw": dict(theta=2.0, nu=2.0),
    "dtw_sc": dict(support="band", radius=3),
    "euclidean": dict(support="dense"),
    "corr": dict(support="dense"),
    "daco": dict(support="dense", lags=5),
}


@pytest.fixture(scope="module")
def ds():
    return load("CBF", n_train=16, n_test=12, T=24)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def engines(request, ds):
    fam = request.param
    je = j_fit(JSpec(fam, **FAMILIES[fam]), jnp.asarray(ds.X_train),
               labels=ds.y_train)
    before = launch_counts()
    te = t_fit(TSpec(fam, **FAMILIES[fam]), ds.X_train, labels=ds.y_train,
               device="cpu")
    return fam, je, te, before


def test_new_families_pairs_gram_knn_match_reference(ds, engines):
    fam, je, te, before = engines
    Q = ds.X_test
    jg = np.asarray(je.gram(jnp.asarray(Q)))
    tg = te.gram(Q).numpy()
    if fam == "dtw_sc":
        assert np.array_equal(tg, jg)
    else:
        np.testing.assert_allclose(tg, jg, **TOL)
    nq, nc = len(Q), len(ds.X_train)
    y = ds.X_train[np.arange(nq) % nc]
    np.testing.assert_allclose(te.pairs(Q, y).numpy(),
                               np.asarray(je.pairs(jnp.asarray(Q),
                                                   jnp.asarray(y))), **TOL)
    nn, nnd = te.knn(Q)
    assert np.array_equal(nn.numpy(), np.asarray(je.knn(jnp.asarray(Q))[0]))
    # exact: the port's own Gram argmin, bit for bit
    assert np.array_equal(nn.numpy(), tg.argmin(axis=1))
    assert np.array_equal(nnd.numpy(), tg[np.arange(nq), tg.argmin(axis=1)])
    assert np.array_equal(te.classify(Q), ds.y_train[nn.numpy()])
    if te.is_kernel:
        # the reference's gram of a kernel family is -gram_log
        np.testing.assert_allclose(te.gram_log(Q).numpy(), -jg, **TOL)
    assert (te.index is None) == (je.index is None)
    assert launch_counts() == before, "a CPU tensor launched a kernel"


@pytest.mark.parametrize("fam", ["krdtw", "sp_krdtw"])
def test_kernel_cascade_matches_reference_and_gram_argmin(fam):
    # a set on which the log-semiring bounds prune (~19% of pairs)
    ds = load("SyntheticControl", n_train=16, n_test=12, T=24)
    kw = dict(support="dense", nu=2.0) if fam == "krdtw" \
        else dict(theta=1.0, nu=2.0)
    je = j_fit(JSpec(fam, **kw), jnp.asarray(ds.X_train), labels=ds.y_train)
    te = t_fit(TSpec(fam, **kw), ds.X_train, labels=ds.y_train,
               device="cpu")
    for f in ("lo", "hi", "wmin_rows", "lo_t", "hi_t", "wmin_cols"):
        assert np.array_equal(getattr(te.index, f), getattr(je.index, f))
    assert np.array_equal(te.index.bsp.plan(), je.index.bsp.plan())
    assert te.index.nu == je.index.nu == 2.0
    np.testing.assert_allclose((te.index.log_s1, te.index.log_s2),
                               (je.index.log_s1, je.index.log_s2), rtol=1e-6)
    Q = ds.X_test
    nn, nnd, st = te.knn(Q, return_stats=True)
    jnn, _, jst = je.knn(jnp.asarray(Q), return_stats=True)
    assert np.array_equal(nn.numpy(), np.asarray(jnn))
    D = -te.gram_log(Q).numpy()
    assert np.array_equal(nn.numpy(), D.argmin(axis=1))
    assert np.array_equal(nnd.numpy(), D[np.arange(len(Q)), D.argmin(1)])
    assert set(st) == set(jst)
    for k in st:
        assert st[k] == pytest.approx(float(jst[k]), abs=1e-6), k
    # the reference's quirk: stage 1 reports the stage-2 bound's rate
    assert st["stage1_prune"] == st["stage2_prune"]
    assert st["pre_dp_prune"] > 0       # the bounds do prune here


def test_svm_fit_predict_error_match_reference(ds):
    jsp = j_learn(jnp.asarray(ds.X_train), theta=2.0)
    jK, jKt = j_svm.svm_gram_series(jnp.asarray(ds.X_train),
                                    jnp.asarray(ds.X_test), kind="sp_krdtw",
                                    sp=jsp, nu=0.5)
    te = engine_from_reference(j_fit(JSpec("sp_krdtw", theta=2.0, nu=0.5),
                                     jnp.asarray(ds.X_train)), device="cpu")
    tK, tKt = t_svm.svm_gram_series(ds.X_train, ds.X_test, kind="sp_krdtw",
                                    sp=te.sp, nu=0.5, device="cpu")
    np.testing.assert_allclose(tK.numpy(), np.asarray(jK), **TOL)
    np.testing.assert_allclose(tKt.numpy(), np.asarray(jKt), **TOL)
    K, Kt = np.asarray(jK), np.asarray(jKt)
    k = ds.n_classes
    for C in (0.1, 10.0):
        ja = np.asarray(j_svm.svm_fit(jnp.asarray(K),
                                      jnp.asarray(ds.y_train), k, C))
        ta = t_svm.svm_fit(torch.tensor(K), ds.y_train, k, C).numpy()
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4)
        jp = np.asarray(j_svm.svm_predict(jnp.asarray(ja), jnp.asarray(Kt),
                                          jnp.asarray(ds.y_train), k))
        tp = t_svm.svm_predict(torch.tensor(ta), torch.tensor(Kt),
                               ds.y_train, k).numpy()
        assert np.array_equal(tp, jp)
    grid = (0.1, 10.0)
    assert t_svm.svm_error(torch.tensor(K), torch.tensor(Kt), ds.y_train,
                           ds.y_test, k, C_grid=grid) == pytest.approx(
        j_svm.svm_error(jnp.asarray(K), jnp.asarray(Kt), ds.y_train,
                        ds.y_test, k, C_grid=grid), abs=1e-7)


@pytest.mark.parametrize("kind", ["krdtw", "krdtw_sc"])
def test_svm_gram_series_dense_kernels_match_reference(ds, kind):
    Xtr, Xte = ds.X_train[:10], ds.X_test[:8]
    jK, jKt = j_svm.svm_gram_series(jnp.asarray(Xtr), jnp.asarray(Xte),
                                    kind=kind, nu=0.5)
    tK, tKt = t_svm.svm_gram_series(Xtr, Xte, kind=kind, nu=0.5,
                                    device="cpu")
    np.testing.assert_allclose(tK.numpy(), np.asarray(jK), **TOL)
    np.testing.assert_allclose(tKt.numpy(), np.asarray(jKt), **TOL)
    np.testing.assert_allclose(np.diagonal(tK.numpy()), 1.0, atol=1e-6)


def test_select_radius_nu_theta_gamma_match_reference(ds):
    Xtr, ytr = ds.X_train, ds.y_train
    fr = (0.0, 0.2)
    assert t_cv.select_radius(Xtr, ytr, fracs=fr, device="cpu").radius == \
        j_cv.select_radius(jnp.asarray(Xtr), ytr, fracs=fr).radius
    a = t_cv.select_nu(Xtr, ytr, grid=(0.5, 2.0), device="cpu")
    b = j_cv.select_nu(jnp.asarray(Xtr), ytr, grid=(0.5, 2.0))
    assert (a.nu, a.radius) == (b.nu, b.radius)
    assert a.loo == pytest.approx(b.loo, abs=1e-6)
    jc = j_counts(jnp.asarray(Xtr))
    tc = t_counts(torch.as_tensor(Xtr))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    for name, kw in (("sp_krdtw", dict(nu=0.5)),
                     ("spdtw", dict(gammas=(0.5,)))):
        tb, tcurve = t_cv.select_theta_gamma(
            Xtr, ytr, name=name, thetas=(0, 30), counts=tc,
            return_curve=True, device="cpu", **kw)
        jb, jcurve = j_cv.select_theta_gamma(
            jnp.asarray(Xtr), ytr, name=name, thetas=(0, 30), counts=jc,
            return_curve=True, **kw)
        assert (tb.theta, tb.gamma, tb.sp.n_cells) == \
            (jb.theta, jb.gamma, jb.sp.n_cells)
        assert [(c[0], c[1], c[3]) for c in tcurve] == \
            [(c[0], c[1], c[3]) for c in jcurve]
        np.testing.assert_allclose([c[2] for c in tcurve],
                                   [c[2] for c in jcurve], atol=1e-6)


def test_converted_kernel_engine_computes_on_the_reference_support(ds):
    for fam, kw in (("sp_krdtw", dict(theta=2.0, nu=0.5)),
                    ("krdtw_sc", dict(support="dense", nu=0.5, radius=4))):
        je = j_fit(JSpec(fam, **kw), jnp.asarray(ds.X_train),
                   labels=ds.y_train)
        te = engine_from_reference(je, device="cpu")
        assert (te.family, te.spec.nu, te.spec.radius) == \
            (fam, je.spec.nu, je.spec.radius)
        if je.sp is not None:
            assert np.array_equal(te.sp.support.numpy(),
                                  np.asarray(je.sp.support))
        np.testing.assert_allclose(
            te.gram_log(ds.X_test[:6]).numpy(),
            np.asarray(je.gram_log(jnp.asarray(ds.X_test[:6]))), **TOL)


def test_dtw_banded_pairs_and_univariate_kernel_routes(ds):
    x = torch.as_tensor(ds.X_test[:6])
    y = torch.as_tensor(ds.X_train[:6])
    import repro.kernels.ops as j_ops
    np.testing.assert_array_equal(
        ops.dtw_banded_pairs(x, y, 3).numpy(),
        np.asarray(j_ops.dtw_banded_pairs(jnp.asarray(x.numpy()),
                                          jnp.asarray(y.numpy()), 3)))
    te = t_fit(TSpec("krdtw", support="dense", nu=0.5), ds.X_train,
               device="cpu")
    qs = torch.zeros((len(ds.X_test),))
    with pytest.raises(ValueError, match="not a kernel"):
        t_fit(TSpec("dtw_sc", support="band"), ds.X_train,
              device="cpu").gram_log(ds.X_test)
    with pytest.raises(ValueError, match="early abandon"):
        te.gram(ds.X_test, thresholds=qs)
