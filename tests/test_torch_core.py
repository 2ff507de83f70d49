"""PyTorch port, core layer: the same numpy inputs through ``repro`` (JAX,
the reference) and ``repro_torch`` (on the CPU).

Datasets, backtracking masks, occupancy counts, learned supports and
block plans must be equal; DP values agree within rtol/atol 1e-5 (the
port repeats ``jax.lax.associative_scan``'s pairing, so they come out
equal here, but a different float association would be legitimate).
Also: the port imports neither ``jax`` nor ``repro``.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the submodules)
import repro_torch.core  # noqa: F401
from repro.core import occupancy as j_occ
from repro.core import paths as j_paths
from repro.data import synthetic_ucr as j_data
from repro_torch.core import occupancy as t_occ
from repro_torch.core import paths as t_paths
from repro_torch.data import synthetic_ucr as t_data

j_dtw = sys.modules["repro.core.dtw"]
t_dtw = sys.modules["repro_torch.core.dtw"]
ROOT = os.path.join(os.path.dirname(__file__), "..")

SETS = [("CBF", dict(n_train=12, n_test=4, T=40)),
        ("SyntheticControl", dict(n_train=12, n_test=4, T=40))]


def _train(name, kw):
    return j_data.load(name, **kw).X_train


@pytest.mark.parametrize("name", sorted(j_data.DATASETS))
def test_datasets_equal(name):
    a = j_data.load(name, n_train=6, n_test=5)
    b = t_data.load(name, n_train=6, n_test=5)
    for f in ("X_train", "y_train", "X_test", "y_test"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.name == b.name


@pytest.mark.parametrize("d", [1, 3])
def test_dtw_matrix_dtw_wdtw_match_reference(d):
    rng = np.random.default_rng(d)
    shape = (30,) if d == 1 else (30, d)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    w = np.where(rng.random((30, 30)) < 0.7,
                 rng.uniform(0.5, 2.0, (30, 30)), 0.0).astype(np.float32)
    np.fill_diagonal(w, 1.0)
    tx, ty, tw = torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w)
    jx, jy, jw = jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_dtw.dtw_matrix(tx, ty).numpy(),
                               np.asarray(j_dtw.dtw_matrix(jx, jy)), **tol)
    np.testing.assert_allclose(t_dtw.dtw_matrix(tx, ty, tw).numpy(),
                               np.asarray(j_dtw.dtw_matrix(jx, jy, jw)),
                               **tol)
    np.testing.assert_allclose(float(t_dtw.dtw(tx, ty)),
                               float(j_dtw.dtw(jx, jy)), **tol)
    np.testing.assert_allclose(float(t_dtw.wdtw(tx, ty, tw)),
                               float(j_dtw.wdtw(jx, jy, jw)), **tol)


def test_band_mask_equal():
    for Tx, Ty, r in ((20, 20, 3), (17, 25, 4), (1, 5, 0)):
        assert np.array_equal(t_dtw.band_mask(Tx, Ty, r).numpy(),
                              np.asarray(j_dtw.band_mask(Tx, Ty, r)))


@pytest.mark.parametrize("name,kw", SETS)
def test_backtrack_masks_equal(name, kw):
    X = _train(name, kw)
    for a, b in ((0, 1), (2, 7), (5, 11)):
        jm = np.asarray(j_paths.optimal_path_mask(jnp.asarray(X[a]),
                                                  jnp.asarray(X[b])))
        tm = t_paths.optimal_path_mask(torch.as_tensor(X[a]),
                                       torch.as_tensor(X[b])).numpy()
        assert np.array_equal(jm, tm)
    # the batched form equals the one-pair form
    tb = t_paths.optimal_path_mask_batch(torch.as_tensor(X[:3]),
                                         torch.as_tensor(X[3:6])).numpy()
    for k in range(3):
        one = t_paths.optimal_path_mask(torch.as_tensor(X[k]),
                                        torch.as_tensor(X[3 + k])).numpy()
        assert np.array_equal(tb[k], one)


def test_path_is_feasible_matches_reference():
    T = 16
    sup = np.zeros((T, T), bool)
    sup[:8, :8] = True
    assert not t_paths.path_is_feasible(torch.as_tensor(sup))
    assert not bool(j_paths.path_is_feasible(jnp.asarray(sup)))
    sup |= np.eye(T, dtype=bool)
    assert t_paths.path_is_feasible(torch.as_tensor(sup))
    assert bool(j_paths.path_is_feasible(jnp.asarray(sup)))


@pytest.mark.parametrize("name,kw", SETS)
def test_pairwise_path_counts_equal(name, kw):
    X = _train(name, kw)
    jc = np.asarray(j_occ.pairwise_path_counts(jnp.asarray(X)))
    tc = t_occ.pairwise_path_counts(torch.as_tensor(X)).numpy()
    assert tc.dtype == np.float32
    assert np.array_equal(jc, tc)
    # chunking does not change the counts
    tc7 = t_occ.pairwise_path_counts(torch.as_tensor(X),
                                     batch_pairs=7).numpy()
    assert np.array_equal(tc, tc7)


@pytest.mark.parametrize("name,kw", SETS)
@pytest.mark.parametrize("gamma", [0.0, 0.5])
def test_learned_support_and_plan_equal(name, kw, gamma):
    X = _train(name, kw)
    counts = np.asarray(j_occ.pairwise_path_counts(jnp.asarray(X)))
    js = j_occ.learn_sparse_paths(jnp.asarray(X), theta=2.0, gamma=gamma,
                                  counts=jnp.asarray(counts))
    ts = t_occ.learn_sparse_paths(torch.as_tensor(X), theta=2.0,
                                  gamma=gamma,
                                  counts=torch.as_tensor(counts.copy()))
    assert np.array_equal(np.asarray(js.support), ts.support.numpy())
    assert np.array_equal(np.asarray(js.weights), ts.weights.numpy())
    assert js.n_cells == ts.n_cells
    for tile in (8, 16):
        jb = j_occ.block_sparsify(js, tile=tile)
        tb = t_occ.block_sparsify(ts, tile=tile)
        assert (jb.T, jb.tile) == (tb.T, tb.tile)
        for f in ("active", "slot", "blocks"):
            assert np.array_equal(getattr(jb, f), getattr(tb, f)), f
        assert np.array_equal(jb.plan(), tb.plan())
    assert t_occ.default_tile(40) == j_occ.default_tile(40)


def test_learned_weights_within_one_ulp_at_any_gamma():
    """The port takes p^-gamma in float64 and rounds once. The
    reference's float32 pow is not correctly rounded at every gamma: on
    these counts at gamma = 0.1, 26 of the 1600 weights differ by one ulp
    (ROADMAP.md, section C). At gamma in {0, 0.5} they are equal (above).
    The support is equal regardless."""
    counts = np.random.default_rng(0).integers(1, 500, (40, 40)) \
        .astype(np.float32)
    js = j_occ.learn_sparse_paths(None, theta=0.0, gamma=0.1,
                                  counts=jnp.asarray(counts))
    ts = t_occ.learn_sparse_paths(None, theta=0.0, gamma=0.1,
                                  counts=torch.as_tensor(counts))
    assert np.array_equal(np.asarray(js.support), ts.support.numpy())
    jw, tw = np.asarray(js.weights), ts.weights.numpy()
    ulps = np.abs(jw.view(np.int32).astype(np.int64)
                  - tw.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert int((ulps > 0).sum()) == 26


def test_repair_re_adds_the_diagonal():
    counts = np.zeros((12, 12), np.float32)
    counts[:6, :6] = 5.0
    js = j_occ.learn_sparse_paths(None, theta=1.0,
                                  counts=jnp.asarray(counts))
    ts = t_occ.learn_sparse_paths(None, theta=1.0,
                                  counts=torch.as_tensor(counts.copy()))
    assert np.array_equal(np.asarray(js.support), ts.support.numpy())
    assert np.array_equal(np.asarray(js.weights), ts.weights.numpy())


# ------------------------------------------------------------ isolation
def _port_files():
    base = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_neither_jax_nor_repro():
    bad = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert not bad, bad


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys; sys.path.insert(0, 'src'); sys.path.insert(0, '.');"
            "import repro_torch, repro_torch.convert, repro_torch.kernels.ops;"
            "import repro_torch.classify.svm, repro_torch.classify.crossval;"
            "import repro_torch.core.krdtw, repro_torch.core.baselines;"
            "import repro_torch.kernels.krdtw_wavefront;"
            "import repro_torch.kernels.dtw_wavefront;"
            "import repro_torch.kernels.dtw_banded;"
            "import repro_torch.kernels.soft_block, repro_torch.core.softdtw;"
            "import repro_torch.cluster, repro_torch.classify.centroid;"
            "import repro_torch.train.optimizer;"
            "import chip_smoke;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
