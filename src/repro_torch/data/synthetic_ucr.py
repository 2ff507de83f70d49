"""Offline UCR-like dataset generators (DESIGN.md §7.1).

The container has no network access, so the UCR archive itself is not
available. These generators reproduce the *families* used in the paper's
Table I whose generating processes are public knowledge (CBF and
SyntheticControl literally are synthetic UCR datasets), with matched
(class-count, train/test size, length) statistics. All series are
z-normalized per the UCR convention.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TSDataset:
    name: str
    X_train: np.ndarray  # (N_tr, T) float32, z-normalized
    y_train: np.ndarray  # (N_tr,) int32
    X_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1

    @property
    def T(self) -> int:
        return self.X_train.shape[1]


def _znorm(X: np.ndarray) -> np.ndarray:
    mu = X.mean(axis=1, keepdims=True)
    sd = X.std(axis=1, keepdims=True) + 1e-8
    return ((X - mu) / sd).astype(np.float32)


def _finish(name, X, y, n_train, rng) -> TSDataset:
    order = rng.permutation(len(X))
    X, y = X[order], y[order]
    return TSDataset(name, _znorm(X[:n_train]), y[:n_train].astype(np.int32),
                     _znorm(X[n_train:]), y[n_train:].astype(np.int32))


# ----------------------------------------------------------------- CBF
def make_cbf(n_train=30, n_test=300, T=128, seed=0) -> TSDataset:
    """Cylinder-Bell-Funnel (Saito 1994) — the classic synthetic 3-class set."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = np.zeros((n, T))
    y = rng.integers(0, 3, size=n)
    t = np.arange(T)
    for i in range(n):
        a = rng.integers(T // 8, T // 3)
        b = a + rng.integers(T // 4, T // 2)
        b = min(b, T - 1)
        amp = 6 + rng.normal()
        noise = rng.normal(size=T)
        on = (t >= a) & (t <= b)
        if y[i] == 0:      # cylinder
            X[i] = amp * on + noise
        elif y[i] == 1:    # bell
            X[i] = amp * on * (t - a) / max(b - a, 1) + noise
        else:              # funnel
            X[i] = amp * on * (b - t) / max(b - a, 1) + noise
    return _finish("CBF", X, y, n_train, rng)


# ------------------------------------------------------ SyntheticControl
def make_synthetic_control(n_train=60, n_test=300, T=60, seed=1) -> TSDataset:
    """Alcock & Manolopoulos control charts — 6 classes."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = np.zeros((n, T))
    y = rng.integers(0, 6, size=n)
    t = np.arange(T, dtype=float)
    for i in range(n):
        m, s = 30.0, 2.0
        base = m + s * rng.normal(size=T)
        k = y[i]
        if k == 1:    # cyclic
            base += (10 + 5 * rng.random()) * np.sin(
                2 * np.pi * t / rng.uniform(10, 15))
        elif k == 2:  # increasing trend
            base += rng.uniform(0.2, 0.5) * t
        elif k == 3:  # decreasing trend
            base -= rng.uniform(0.2, 0.5) * t
        elif k == 4:  # upward shift
            base += (t >= rng.integers(T // 3, 2 * T // 3)) * rng.uniform(7.5, 20)
        elif k == 5:  # downward shift
            base -= (t >= rng.integers(T // 3, 2 * T // 3)) * rng.uniform(7.5, 20)
        X[i] = base
    return _finish("SyntheticControl", X, y, n_train, rng)


# ---------------------------------------------------------- TwoPatterns
def make_two_patterns(n_train=40, n_test=200, T=96, seed=2) -> TSDataset:
    """Up/down step pairs in random positions — 4 classes (UU, UD, DU, DD)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = rng.normal(scale=0.3, size=(n, T))
    y = rng.integers(0, 4, size=n)
    for i in range(n):
        p1 = rng.integers(T // 16, T // 2 - T // 8)
        p2 = rng.integers(T // 2, T - T // 8)
        w = T // 12
        s1 = 1.0 if y[i] in (0, 1) else -1.0   # first pattern up/down
        s2 = 1.0 if y[i] in (0, 2) else -1.0   # second pattern up/down
        X[i, p1:p1 + w] += 5.0 * s1
        X[i, p2:p2 + w] += 5.0 * s2
    return _finish("TwoPatterns", X, y, n_train, rng)


# -------------------------------------------------------------- GunPoint
def make_gunpoint(n_train=50, n_test=150, T=96, seed=3) -> TSDataset:
    """Bimodal motion profiles with phase jitter — 2 classes."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = np.zeros((n, T))
    y = rng.integers(0, 2, size=n)
    t = np.linspace(0, 1, T)
    for i in range(n):
        c = rng.uniform(0.4, 0.6)
        w = rng.uniform(0.08, 0.12)
        bump = np.exp(-0.5 * ((t - c) / w) ** 2)
        if y[i] == 1:  # "gun": secondary dip before the peak
            bump -= 0.5 * np.exp(-0.5 * ((t - c + 0.18) / (w * 0.7)) ** 2)
        X[i] = bump * rng.uniform(4, 6) + 0.15 * rng.normal(size=T)
    return _finish("GunPoint", X, y, n_train, rng)


# ------------------------------------------------------------------ Trace
def make_trace(n_train=40, n_test=100, T=100, seed=4) -> TSDataset:
    """Sinusoids with/without step transients — 4 classes (Trace-like)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = np.zeros((n, T))
    y = rng.integers(0, 4, size=n)
    t = np.linspace(0, 1, T)
    for i in range(n):
        f = 2 if y[i] < 2 else 4
        x = np.sin(2 * np.pi * f * (t + rng.uniform(0, 0.1)))
        if y[i] % 2 == 1:  # add a step transient
            p = rng.integers(T // 3, 2 * T // 3)
            x[p:] += 2.0
        X[i] = x + 0.1 * rng.normal(size=T)
    return _finish("Trace", X, y, n_train, rng)


# ------------------------------------------------------------------- ECG
def make_ecg(n_train=40, n_test=200, T=96, seed=5) -> TSDataset:
    """QRS-like pulse trains; classes differ in T-wave polarity/latency."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = np.zeros((n, T))
    y = rng.integers(0, 2, size=n)
    t = np.linspace(0, 1, T)
    for i in range(n):
        qrs_c = rng.uniform(0.3, 0.4)
        x = (1.2 * np.exp(-0.5 * ((t - qrs_c) / 0.015) ** 2)
             - 0.3 * np.exp(-0.5 * ((t - qrs_c + 0.05) / 0.02) ** 2))
        tw_c = qrs_c + (0.25 if y[i] == 0 else 0.35)
        pol = 1.0 if y[i] == 0 else -0.6
        x += pol * 0.4 * np.exp(-0.5 * ((t - tw_c) / 0.06) ** 2)
        X[i] = x + 0.05 * rng.normal(size=T)
    return _finish("ECG", X, y, n_train, rng)


# ---------------------------------------------------------------- Wave
def make_waves(n_train=40, n_test=150, T=128, seed=6) -> TSDataset:
    """3-class frequency/chirp discrimination with warp jitter."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    X = np.zeros((n, T))
    y = rng.integers(0, 3, size=n)
    for i in range(n):
        # random smooth monotone time warp
        knots = np.sort(rng.uniform(0, 1, 4))
        u = np.interp(np.linspace(0, 1, T), np.linspace(0, 1, 6),
                      np.concatenate([[0], knots, [1]]))
        if y[i] == 0:
            x = np.sin(2 * np.pi * 3 * u)
        elif y[i] == 1:
            x = np.sin(2 * np.pi * 5 * u)
        else:
            x = np.sin(2 * np.pi * (2 + 4 * u) * u)   # chirp
        X[i] = x + 0.15 * rng.normal(size=T)
    return _finish("Waves", X, y, n_train, rng)


DATASETS: Dict[str, Callable[[], TSDataset]] = {
    "CBF": make_cbf,
    "SyntheticControl": make_synthetic_control,
    "TwoPatterns": make_two_patterns,
    "GunPoint": make_gunpoint,
    "Trace": make_trace,
    "ECG": make_ecg,
    "Waves": make_waves,
}


def load(name: str, **kw) -> TSDataset:
    return DATASETS[name](**kw)
