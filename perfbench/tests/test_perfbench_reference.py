"""The plain reference equals the port's plain path at a small size on
the CPU: the generator, the occupancy counts and support, SP-DTW,
log SP-K_rdtw and the SVM."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import krdtw, occupancy, spdtw, svm
from perfbench.tests import helpers  # noqa: F401  (puts src on the path)
from perfbench.traffic.two_patterns import two_patterns


@pytest.fixture(scope="module")
def series():
    X, y = two_patterns(56, 32, np.random.default_rng(7))
    return torch.as_tensor(X), y


def test_generator_is_the_ports(series):
    from repro_torch.data.synthetic_ucr import make_two_patterns
    ds = make_two_patterns(n_train=30, n_test=26, T=32, seed=5)
    X, y = two_patterns(56, 32, np.random.default_rng(5))
    np.testing.assert_array_equal(X, np.concatenate([ds.X_train,
                                                     ds.X_test]))
    np.testing.assert_array_equal(y, np.concatenate([ds.y_train,
                                                     ds.y_test]))


@pytest.mark.parametrize("theta,gamma", [(0, 0.0), (8, 0.0), (30, 0.5)])
def test_support_equals_the_ports(series, theta, gamma):
    from repro_torch.core.occupancy import (learn_sparse_paths,
                                            pairwise_path_counts)
    X = series[0][:40]
    c = occupancy.path_counts(X, chunk=300)
    want = pairwise_path_counts(X)
    np.testing.assert_array_equal(c.numpy(), want.numpy().astype(np.int64))
    sup, w = occupancy.learn_support(c, theta, gamma)
    sp = learn_sparse_paths(X, theta=theta, gamma=gamma, counts=want)
    np.testing.assert_array_equal(sup, sp.support.numpy())
    np.testing.assert_allclose(w, sp.weights.numpy(), rtol=1e-6)


def test_spdtw_equals_the_ports(series):
    from repro_torch.core.engine import fit
    from repro_torch.core.spec import MeasureSpec
    X, y = series
    Xtr, Q = X[:40], X[40:]
    sup, w = occupancy.learn_support(occupancy.path_counts(Xtr), 8, 0.5)
    D = spdtw.spdtw_cross(Q, Xtr, w, pairs=97)
    eng = fit(MeasureSpec("spdtw", theta=8, weight_gamma=0.5), Xtr,
              labels=y[:40], device="cpu")
    torch.testing.assert_close(D, eng.gram(Q), rtol=1e-5, atol=0)
    nn, d = eng.knn(Q)
    np.testing.assert_array_equal(nn.numpy(), D.argmin(1).numpy())


@pytest.mark.parametrize("nu", [0.1, 2.0])
def test_log_krdtw_equals_the_ports(series, nu):
    from repro_torch.core.krdtw import log_krdtw_batch
    X = series[0]
    Xtr, Q = X[:40], X[40:]
    sup, _ = occupancy.learn_support(occupancy.path_counts(Xtr), 8, 0.0)
    R = krdtw.log_krdtw_cross(Q, Xtr, nu, sup, pairs=111)
    P = log_krdtw_batch(Q.repeat_interleave(40, 0), Xtr.repeat(16, 1), nu,
                        torch.as_tensor(sup)).reshape(16, 40)
    torch.testing.assert_close(R, P, rtol=1e-5, atol=1e-5)
    U = krdtw.log_krdtw_cross(Xtr, Xtr, nu, sup, upper=True)
    torch.testing.assert_close(U, U.T)


def test_svm_equals_the_ports(series):
    from repro_torch.classify.svm import svm_fit, svm_predict
    X, y = series
    sup, _ = occupancy.learn_support(occupancy.path_counts(X), 8, 0.0)
    lg = krdtw.log_krdtw_cross(X, X, 0.1, sup, upper=True)
    d = torch.diagonal(lg)
    K = svm.normalized(lg, d, d)
    yt = torch.as_tensor(y)
    for C in svm.C_GRID:
        a = svm.fit(K, yt, 4, C)
        torch.testing.assert_close(a, svm_fit(K, yt, 4, C), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(
            svm.decisions(a, K, yt, 4).argmax(1).numpy(),
            svm_predict(svm_fit(K, yt, 4, C), K, yt, 4).numpy())
