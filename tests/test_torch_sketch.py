"""PyTorch port, the Random Warping Series sketch tier on the CPU against
the reference: the sketch features, ``knn(mode="sketch")`` (shortlist,
re-rank, ``approx``), ``svm_rws_series`` and the port's own anchors.

jax's threefry draws have no torch twin, so every comparison with the
reference runs on the reference's anchors: carried across by
``convert`` (a reference engine's state), or patched into the port's
``random_anchors`` for ``svm_rws_series``. Tolerances: features and SVM
blocks within rel 1e-5 (features rel 1e-6 where both sides run the same
DP); neighbours, shortlist sizes and DP counts equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.classify.svm  # noqa: F401  (registers the submodule)
import sys
from repro.core import learn_sparse_paths as j_learn
from repro.core.engine import fit as j_fit
from repro.core.sketch import ANCHOR_SALT as J_SALT
from repro.core.sketch import build_sketch_index as j_build
from repro.core.sketch import random_anchors as j_anchors
from repro.core.spec import MeasureSpec as JSpec
from repro_torch.classify import svm as t_svm
from repro_torch.convert import engine_from_reference
from repro_torch.core import sketch as t_sketch
from repro_torch.core.engine import fit as t_fit
from repro_torch.core.spec import MeasureSpec as TSpec
from repro_torch.kernels import launch_counts

j_svm = sys.modules["repro.classify.svm"]
R = 6


def _toy(T=48, n=24, seed=0, nq=10):
    rng = np.random.default_rng(seed)
    base = np.sin(np.linspace(0, 3 * np.pi, T))
    X = (base[None] + 0.3 * rng.normal(size=(n, T))).astype(np.float32)
    # retrieval-style queries: jittered corpus entries (close neighbours)
    src = rng.integers(0, n, nq)
    Q = X[src] + 0.05 * rng.normal(size=(nq, T)).astype(np.float32)
    return X, Q.astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    X, Q = _toy()
    sp = j_learn(jnp.asarray(X), theta=1.0)
    je = j_fit(JSpec("spdtw", sketch_r=R, seed=11), jnp.asarray(X), sp=sp)
    before = launch_counts()
    te = engine_from_reference(je, device="cpu")
    return X, Q, je, te, before


def test_carried_sketch_and_features_match_reference(engines):
    X, Q, je, te, before = engines
    jsi, tsi = je.index.sketch, te.index.sketch
    assert te.spec.sketch_r == R and tsi.R == R and tsi.seed == 11
    assert np.array_equal(tsi.anchors.numpy(), np.asarray(jsi.anchors))
    # the port's embedding of the corpus and of the queries on the
    # reference's anchors
    np.testing.assert_allclose(te.sketch_embed(X).numpy(),
                               np.asarray(jsi.sketch), rtol=1e-6)
    np.testing.assert_allclose(te.sketch_embed(Q).numpy(),
                               np.asarray(je.sketch_embed(jnp.asarray(Q))),
                               rtol=1e-6)
    assert launch_counts() == before


@pytest.mark.parametrize("top_c", (4, 8, None))
@pytest.mark.parametrize("approx", (False, True))
def test_sketch_knn_matches_reference(engines, top_c, approx):
    X, Q, je, te, _ = engines
    c = len(X) if top_c is None else top_c
    jnn, jd, js = je.knn(jnp.asarray(Q), mode="sketch", top_c=c,
                         approx=approx, return_stats=True)
    nn, d, st = te.knn(Q, mode="sketch", top_c=c, approx=approx,
                       return_stats=True)
    assert nn.dtype == torch.int32
    assert np.array_equal(nn.numpy(), np.asarray(jnn))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)
    for k in ("n_queries", "n_candidates", "shortlist_c", "mode",
              "dp_pairs"):
        assert st[k] == js[k], k
    assert {"t_embed_s", "t_shortlist_s", "t_rerank_s"} <= set(st)


def test_full_shortlist_equals_exact_cascade(engines):
    X, Q, _, te, _ = engines
    nn, d = te.knn(Q, mode="sketch", top_c=len(X))
    enn, ed = te.knn(Q)
    assert torch.equal(nn, enn) and torch.equal(d, ed)
    with pytest.raises(ValueError):
        t_fit(TSpec("spdtw"), X, device="cpu").knn(Q, mode="sketch")


def test_soft_sketch_matches_reference(engines):
    X, _, je, te, _ = engines
    anchors = je.index.sketch.anchors
    jsi = j_build(jnp.asarray(X), anchors, bsp=je.bsp, weights=je.weights,
                  gamma=0.1)
    tsi = t_sketch.build_sketch_index(
        te.corpus, torch.as_tensor(np.array(anchors)), bsp=te.bsp,
        weights=te.weights, gamma=0.1)
    np.testing.assert_allclose(tsi.sketch.numpy(), np.asarray(jsi.sketch),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tsi.sq.numpy(), np.asarray(jsi.sq),
                               rtol=1e-5)


def test_own_anchors_are_deterministic_per_seed():
    X, Q = _toy()
    spec = TSpec("spdtw", sketch_r=R, seed=11)
    e1 = t_fit(spec, X, device="cpu")
    e2 = t_fit(spec, X, sp=e1.sp, device="cpu")
    s1, s2 = e1.index.sketch, e2.index.sketch
    assert torch.equal(s1.anchors, s2.anchors)
    assert torch.equal(s1.sketch, s2.sketch)
    e3 = t_fit(spec.replace(seed=12), X, sp=e1.sp, device="cpu")
    assert not torch.equal(s1.anchors, e3.index.sketch.anchors)
    A1 = t_sketch.random_anchors(t_sketch.anchor_generator(7), 5, 32)
    A2 = t_sketch.random_anchors(t_sketch.anchor_generator(7), 5, 32)
    assert A1.shape == (5, 32) and torch.equal(A1, A2)
    np.testing.assert_allclose(A1.mean(dim=1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(A1.std(dim=1, unbiased=False).numpy(), 1.0,
                               atol=1e-3)
    A3 = t_sketch.random_anchors(t_sketch.anchor_generator(0), 4, 24, d=3)
    assert A3.shape == (4, 24, 3) and bool(torch.isfinite(A3).all())
    # the engine's own sketch search: exact at full coverage
    nn, _ = e1.knn(Q, mode="sketch", top_c=len(X))
    assert torch.equal(nn, e1.knn(Q)[0])


@pytest.mark.parametrize("T", (24, 60, 96, 128))
def test_interp_matches_numpy_on_the_anchor_lengths(T):
    max_len = max(5, T // 4)
    grid = torch.arange(max_len, dtype=torch.float32)
    rng = np.random.default_rng(T)
    fp = torch.as_tensor(np.cumsum(rng.normal(size=max_len)).astype(
        np.float32))
    for D in range(4, max_len + 1):
        pos = torch.linspace(0.0, 1.0, T) * float(D - 1)
        got = t_sketch.interp(pos, grid, fp)
        np.testing.assert_allclose(
            got.numpy(), np.interp(pos.numpy(), grid.numpy(), fp.numpy()),
            rtol=1e-6, atol=1e-6)
    # jnp.interp's edges: past either end, the right edge itself, and a
    # zero-width interval
    x = torch.tensor([-1.0, 0.0, max_len - 1.0, max_len + 3.0])
    want = jnp.interp(jnp.asarray(x.numpy()), jnp.asarray(grid.numpy()),
                      jnp.asarray(fp.numpy()))
    assert np.array_equal(t_sketch.interp(x, grid, fp).numpy(),
                          np.asarray(want))
    knots = torch.tensor([0.0, 1.0, 1.0, 2.0])
    vals = torch.tensor([0.0, 1.0, 5.0, 6.0])
    xs = torch.tensor([0.5, 1.0, 1.5])
    assert np.array_equal(
        t_sketch.interp(xs, knots, vals).numpy(),
        np.asarray(jnp.interp(jnp.asarray(xs.numpy()),
                              jnp.asarray(knots.numpy()),
                              jnp.asarray(vals.numpy()))))


def test_svm_rws_series_matches_reference(monkeypatch):
    X, Q = _toy(n=20, nq=12)
    Rr, seed = 8, 5
    spec = JSpec("spdtw", theta=1.0, seed=seed, sketch_r=Rr)
    want_anchors = np.asarray(j_anchors(
        jax.random.fold_in(spec.key(), J_SALT), Rr, X.shape[1]))
    monkeypatch.setattr(t_sketch, "random_anchors",
                        lambda *a, **k: torch.as_tensor(want_anchors))
    Kj, Ktj = j_svm.svm_rws_series(X, Q, R=Rr, seed=seed)
    K, Kt = t_svm.svm_rws_series(X, Q, R=Rr, seed=seed, device="cpu")
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-5)
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Ktj), rtol=1e-5)
    assert K.shape == (20, 20) and Kt.shape == (12, 20)
