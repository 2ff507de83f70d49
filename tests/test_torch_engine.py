"""PyTorch port, engine layer: ``fit`` -> ``SimilarityEngine`` on both
packages (the port on the CPU, through its plain versions).

Gram, pair and 1-NN distances agree with the reference within 1e-5 and
with the dense core DP within 1e-4; the neighbours, the cascade's integer
counters and the classification errors are equal; the port's cascade
neighbours equal its own Gram argmin bit for bit. The same holds for a
port engine built from the reference's fitted arrays (``convert``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.classify import knn as j_knn
from repro.core.engine import fit as j_fit
from repro.core.spec import MeasureSpec as JSpec
from repro.data import load
from repro_torch.classify import knn as t_knn
from repro_torch.convert import engine_from_reference, state_from_reference
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.kernels import launch_counts, ref

TOL = dict(rtol=1e-5, atol=1e-5)
INT_STATS = ("n_queries", "n_candidates", "seed_k", "n_centroids",
             "prefix_tiles", "plan_tiles", "dp_pairs")
CASES = {
    "spdtw-CBF": ("spdtw", "CBF", dict(n_train=10, n_test=6, T=40)),
    "dtw-SyntheticControl": ("dtw", "SyntheticControl",
                             dict(n_train=10, n_test=6, T=32)),
}


def _spec_kw(family):
    return dict(theta=2.0, weight_gamma=0.5) if family == "spdtw" \
        else dict(support="dense")


@pytest.fixture(scope="module", params=sorted(CASES))
def fitted(request):
    family, name, kw = CASES[request.param]
    ds = load(name, **kw)
    je = j_fit(JSpec(family, **_spec_kw(family)), jnp.asarray(ds.X_train),
               labels=ds.y_train)
    before = launch_counts()
    te = t_fit(TSpec(family, **_spec_kw(family)), ds.X_train,
               labels=ds.y_train, device="cpu")
    return ds, je, te, before


def test_fitted_state_equal(fitted):
    _, je, te, _ = fitted
    assert te.device.type == "cpu" and te.T == je.T and te.d == je.d
    assert np.array_equal(te.bsp.plan(), je.bsp.plan())
    assert np.array_equal(te.bsp.blocks, je.bsp.blocks)
    if je.sp is not None:
        assert np.array_equal(te.sp.weights.numpy(), np.asarray(je.sp.weights))
        assert np.array_equal(te.sp.counts.numpy(), np.asarray(je.sp.counts))
    for f in ("lo", "hi", "wmin_rows", "lo_t", "hi_t", "wmin_cols"):
        assert np.array_equal(getattr(te.index, f), getattr(je.index, f)), f
    np.testing.assert_allclose(te.index.env_lo.numpy(),
                               np.asarray(je.index.env_lo))


def test_gram_and_pairs_match_reference_and_dense_core(fitted):
    ds, je, te, _ = fitted
    Gj = np.asarray(je.gram(jnp.asarray(ds.X_test)))
    Gt = te.gram(ds.X_test)
    np.testing.assert_allclose(Gt.numpy(), Gj, **TOL)
    w = te.weights if te.family == "spdtw" else None
    dense = ref.wdtw_cross(torch.as_tensor(ds.X_test),
                           torch.as_tensor(ds.X_train), w)
    np.testing.assert_allclose(Gt.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-4)
    x, y = ds.X_test[:6], ds.X_train[:6]
    np.testing.assert_allclose(
        te.pairs(x, y).numpy(),
        np.asarray(je.pairs(jnp.asarray(x), jnp.asarray(y))), **TOL)


def test_knn_cascade_matches_reference(fitted):
    ds, je, te, before = fitted
    nj, dj, sj = je.knn(jnp.asarray(ds.X_test), return_stats=True)
    nt, dt, st = te.knn(ds.X_test, return_stats=True)
    assert np.array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **TOL)
    for k in INT_STATS:
        assert isinstance(st[k], int) and st[k] == int(sj[k]), k
    for k in ("stage1_prune", "stage2_prune", "stage3_prune",
              "pre_dp_prune", "dp_abandoned"):
        assert abs(st[k] - float(sj[k])) < 1e-6, k
    # the port's own invariant: cascade nn == its full Gram argmin. The
    # spdtw Gram runs the cascade's tile engines, so the distances are
    # equal too; the CPU dtw Gram is the dense DP, whose float
    # association differs from the tile sweep's
    G = te.gram(ds.X_test)
    assert torch.equal(nt, torch.argmin(G, dim=1).to(torch.int32))
    nn_d = G.gather(1, nt[:, None].long())[:, 0]
    if te.family == "spdtw":
        assert torch.equal(dt, nn_d)
    else:
        np.testing.assert_allclose(dt.numpy(), nn_d.numpy(), **TOL)
    # the dense cascade route agrees
    nd, _ = te.knn(ds.X_test, impl="dense")
    assert torch.equal(nd, nt)
    assert launch_counts() == before, "a CPU engine launched a kernel"


def test_classification_errors_match_reference(fitted):
    ds, je, te, _ = fitted
    pj = np.asarray(je.classify(jnp.asarray(ds.X_test)))
    pt = te.classify(ds.X_test)
    assert np.array_equal(pt, pj)
    Gj = je.gram(jnp.asarray(ds.X_train), jnp.asarray(ds.X_train))
    Gt = te.gram(ds.X_train, ds.X_train)
    assert t_knn.loo_error(Gt, ds.y_train) == j_knn.loo_error(Gj,
                                                              ds.y_train)
    assert t_knn.knn_error(te.gram(ds.X_test), ds.y_train, ds.y_test) == \
        j_knn.knn_error(je.gram(jnp.asarray(ds.X_test)), ds.y_train,
                        ds.y_test)


def test_converted_engine_computes_on_the_reference_support(fitted):
    ds, je, _, _ = fitted
    ce = engine_from_reference(je, device="cpu")
    state = state_from_reference(je)
    assert np.array_equal(ce.bsp.plan(), state["bsp"]["meta"])
    nj, _ = je.knn(jnp.asarray(ds.X_test))
    nc, _ = ce.knn(ds.X_test)
    assert np.array_equal(nc.numpy(), np.asarray(nj))
    np.testing.assert_allclose(ce.gram(ds.X_test).numpy(),
                               np.asarray(je.gram(jnp.asarray(ds.X_test))),
                               **TOL)
    assert np.array_equal(ce.classify(ds.X_test),
                          np.asarray(je.classify(jnp.asarray(ds.X_test))))


def test_multivariate_engine_matches_reference():
    rng = np.random.default_rng(4)
    base = np.sin(np.linspace(0, 3 * np.pi, 24))[None, :, None]
    X = (base + 0.4 * rng.normal(size=(8, 24, 3))).astype(np.float32)
    Q = (base + 0.4 * rng.normal(size=(4, 24, 3))).astype(np.float32)
    y = np.arange(8) % 2
    je = j_fit(JSpec("spdtw", theta=1.0), jnp.asarray(X), labels=y)
    te = t_fit(TSpec("spdtw", theta=1.0), X, labels=y, device="cpu")
    assert te.d == 3
    assert np.array_equal(te.sp.weights.numpy(), np.asarray(je.sp.weights))
    Gt = te.gram(Q)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(je.gram(jnp.asarray(Q))),
                               **TOL)
    nj, _ = je.knn(jnp.asarray(Q))
    nt, _ = te.knn(Q)
    assert np.array_equal(nt.numpy(), np.asarray(nj))
    assert torch.equal(nt, torch.argmin(Gt, dim=1).to(torch.int32))


def test_knn_error_series_and_with_corpus(fitted):
    ds, je, te, _ = fitted
    sp_t = te.sp if te.family == "spdtw" else None
    sp_j = je.sp if je.family == "spdtw" else None
    for cascade in (True, False):
        assert t_knn.knn_error_series(
            ds.X_test, ds.X_train, ds.y_train, ds.y_test, kind=te.family,
            sp=sp_t, cascade=cascade, device="cpu") == \
            j_knn.knn_error_series(
                jnp.asarray(ds.X_test), jnp.asarray(ds.X_train), ds.y_train,
                ds.y_test, kind=je.family, sp=sp_j, cascade=cascade)
    e2 = te.with_corpus(ds.X_test, labels=ds.y_test)
    assert e2.version == 1 and e2.corpus_size == len(ds.X_test)
    assert e2.bsp is te.bsp


def test_band_support_matches_reference_grid_and_dense_core():
    ds = load("CBF", n_train=6, n_test=4, T=24)
    je = j_fit(JSpec("spdtw", support="band", radius=3),
               jnp.asarray(ds.X_train))
    te = t_fit(TSpec("spdtw", support="band", radius=3), ds.X_train,
               device="cpu")
    assert np.array_equal(te.weights.numpy(), np.asarray(je.weights))
    assert np.array_equal(te.bsp.plan(), je.bsp.plan())
    dense = ref.wdtw_cross(torch.as_tensor(ds.X_test),
                           torch.as_tensor(ds.X_train), te.weights)
    np.testing.assert_allclose(te.gram(ds.X_test).numpy(), dense.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_entry_points_default_to_cuda():
    ds = load("CBF", n_train=4, n_test=2, T=16)
    spec = TSpec("dtw", support="dense")
    if torch.cuda.is_available():
        assert t_fit(spec, ds.X_train).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_fit(spec, ds.X_train)
    # every family fits; a sketch search needs a spec fit with a sketch
    eng = t_fit(TSpec("krdtw", support="dense"), ds.X_train, device="cpu")
    with pytest.raises(ValueError, match="sketch_r > 0"):
        eng.knn(ds.X_test, mode="sketch")
