"""Dataset-scale embedding map of the corpus sketch matrix.

The (N, R) Random Warping Series sketch matrix already *is* a Euclidean
embedding of the corpus under the alignment measure; projecting it to
its top two principal axes gives a dataset map cheap enough to export
on every fit. The PCA here is dependency-free by design — deflated
power iteration on the centered covariance, seeded start vectors, a
deterministic sign convention — so the artifact is reproducible from
``(engine, seed)`` with nothing beyond numpy. The port's copy of the
reference's module: the same numpy arithmetic and draws, on the sketch
brought to the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

# rng salt for the power-iteration start vectors
EMBED_SALT = 0xE3BD


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array as a float64 host array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def power_iteration_pca(X, n_components: int = 2, *, iters: int = 200,
                        tol: float = 1e-9, seed: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PCA of an (N, R) matrix via deflated power iteration, numpy only.

    Returns ``(components, coords, explained_var)``: components is
    (n_components, R) orthonormal rows sorted by variance, coords the
    (N, n_components) projection of the centered data, explained_var
    the fraction of total variance each axis captures. Deterministic:
    seeded start vectors, and each component's sign is fixed so its
    largest-magnitude coordinate is positive.
    """
    X = host(X)
    if X.ndim != 2:
        raise ValueError("power_iteration_pca wants an (N, R) matrix")
    N, R = X.shape
    k = int(min(n_components, R, max(N - 1, 1)))
    if k < 1:
        raise ValueError("need at least one component")
    Xc = X - X.mean(axis=0)
    denom = max(N - 1, 1)
    total_var = float((Xc * Xc).sum() / denom)
    rng = np.random.default_rng([int(seed), EMBED_SALT])
    comps, lams = [], []
    for _ in range(k):
        v = rng.normal(size=R)
        v /= max(np.linalg.norm(v), 1e-30)
        for _ in range(int(iters)):
            w = Xc.T @ (Xc @ v)                     # covariance apply
            for u in comps:                         # deflate found axes
                w -= (w @ u) * u
            nw = np.linalg.norm(w)
            if nw < 1e-30:                          # exhausted variance
                break
            w /= nw
            done = abs(abs(float(w @ v)) - 1.0) < tol
            v = w
            if done:
                break
        s = np.sign(v[int(np.argmax(np.abs(v)))])
        v = v * (s if s != 0 else 1.0)
        comps.append(v)
        lams.append(float(((Xc @ v) ** 2).sum() / denom))
    components = np.stack(comps)                    # (k, R)
    coords = Xc @ components.T                      # (N, k)
    explained = np.asarray(lams) / max(total_var, 1e-30)
    return components, coords, explained


def sketch_map(engine, *, n_components: int = 2, labels=None,
               max_points: int = 4096) -> Dict[str, object]:
    """2-D dataset map of a fitted engine's corpus: PCA of the (N, R)
    sketch matrix with per-class centroid overlays.

    Returns the JSON-ready payload the ``BENCH_embed.json`` schema
    gates: projected ``coords`` (truncated to ``max_points`` rows, the
    truncation recorded), ``explained_var`` per axis, an orthonormality
    residual for the recovered axes, and one ``classes`` entry per
    label value (count + 2-D centroid). ``labels`` defaults to the
    engine's fitted labels; unlabeled corpora get a single ``null``
    class covering every row.
    """
    index = engine.index
    if index is None or index.sketch is None:
        raise ValueError("sketch_map reads the sketch tier: fit with "
                         "sketch_r > 0")
    S = host(index.sketch.sketch)
    N = S.shape[0]
    comps, coords, explained = power_iteration_pca(
        S, n_components, seed=int(engine.spec.seed))
    G = comps @ comps.T
    ortho_err = float(np.abs(G - np.eye(G.shape[0])).max())
    if labels is None and engine.labels is not None:
        labels = np.asarray(engine.labels)
    classes = []
    if labels is not None:
        labels = np.asarray(labels)
        if labels.shape[0] != N:
            raise ValueError("labels must cover the corpus")
        for val in np.unique(labels):
            sel = labels == val
            classes.append({"label": int(val), "n": int(sel.sum()),
                            "centroid": [float(c)
                                         for c in coords[sel].mean(axis=0)]})
    else:
        classes.append({"label": None, "n": int(N),
                        "centroid": [float(c)
                                     for c in coords.mean(axis=0)]})
    keep = int(min(N, max_points))
    return {"n_series": int(N), "R": int(S.shape[1]),
            "n_components": int(coords.shape[1]),
            "seed": int(engine.spec.seed),
            "explained_var": [float(e) for e in explained],
            "orthonormal_err": ortho_err,
            "coords": np.round(coords[:keep], 6).tolist(),
            "coords_truncated": bool(keep < N),
            "classes": classes}
