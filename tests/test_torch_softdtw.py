"""PyTorch port, the dense soft-SP-DTW oracle (``repro_torch.core.softdtw``)
against the reference's (``repro.core.softdtw``) on the same numpy inputs,
in float64: values, expected-alignment matrices E and the gradients of
x, y and the weights, at 1e-6.

The reference runs under ``jax.enable_x64(True)`` as a local context, so
the flag never leaks into other test files of the same worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import softdtw as j_sd
from repro_torch.core import softdtw as t_sd

TOL = 1e-6


def _weights(T, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "full":
        return np.ones((T, T))
    i = np.arange(T)
    sup = (np.abs(i[:, None] - i[None, :]) <= 2) | (rng.random((T, T)) < 0.2)
    w = np.where(sup, rng.uniform(0.5, 2.0, (T, T)), 0.0)
    if kind == "infeasible":
        w[-1, -1] = 0.0
    return w


def _series(seed, T, d):
    rng = np.random.default_rng(seed)
    shape = (T,) if d == 1 else (T, d)
    return rng.normal(size=shape), rng.normal(size=shape)


def _ref(fn, *args):
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args))
        return jax.tree.map(np.asarray, out)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d,kind,gamma", [(1, "sparse", 0.1),
                                          (1, "full", 1.0),
                                          (3, "sparse", 0.5)])
def test_value_and_gradients_match_reference(d, kind, gamma):
    T = 14
    x, y = _series(d + 10, T, d)
    w = _weights(T, d, kind)
    v_ref = _ref(lambda a, b, c: j_sd.soft_wdtw(a, b, c, gamma), x, y, w)
    g_ref = _ref(lambda a, b, c: jax.grad(
        lambda *z: j_sd.soft_wdtw(*z, gamma), argnums=(0, 1, 2))(a, b, c),
        x, y, w)
    xt, yt, wt = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    v = t_sd.soft_wdtw(xt, yt, wt, gamma)
    v.backward()
    _close(v.detach(), v_ref)
    for got, want in zip((xt.grad, yt.grad, wt.grad), g_ref):
        _close(got, want)
    # E is zero outside the support, so is the weight gradient
    assert bool((wt.grad[torch.tensor(w) == 0] == 0).all())


@pytest.mark.parametrize("gamma", [0.05, 0.7])
def test_expected_alignment_matches_reference(gamma):
    T = 16
    x, y = _series(5, T, 1)
    w = _weights(T, 6, "sparse")
    E_ref = _ref(lambda a, b, c: j_sd.soft_alignment(a, b, c, gamma), x, y, w)
    E = t_sd.soft_alignment(torch.tensor(x), torch.tensor(y),
                            torch.tensor(w), gamma)
    _close(E, E_ref)
    assert abs(float(E[-1, -1]) - 1.0) < TOL
    assert float(E[torch.tensor(w) == 0].abs().max()) == 0.0


def test_infeasible_support_gives_inf_and_zero_gradients():
    T = 10
    x, y = _series(7, T, 1)
    w = _weights(T, 8, "infeasible")
    v_ref = _ref(lambda a, b, c: j_sd.soft_wdtw(a, b, c, 0.3), x, y, w)
    xt, yt, wt = (torch.tensor(a, requires_grad=True) for a in (x, y, w))
    v = t_sd.soft_wdtw(xt, yt, wt, 0.3)
    v.backward()
    # the reference's INF is float32 1e30 widened, the port's 1e30
    assert float(v) >= 1e29 and float(v_ref) >= 1e29
    for g in (xt.grad, yt.grad, wt.grad):
        assert float(g.abs().max()) == 0.0


def test_logsumexp_scan_and_soft_dtw_match_reference():
    rng = np.random.default_rng(9)
    g = rng.normal(size=(3, 13))
    t = rng.normal(size=(3, 13))
    want = _ref(lambda a, b: j_sd.logsumexp_scan(a, b, axis=-1), g, t)
    _close(t_sd.logsumexp_scan(torch.tensor(g), torch.tensor(t)), want)
    x, y = _series(11, 12, 1)
    _close(t_sd.soft_dtw(torch.tensor(x), torch.tensor(y), 0.4),
           _ref(lambda a, b: j_sd.soft_dtw(a, b, 0.4), x, y))
