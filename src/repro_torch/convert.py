"""State carried across: a fitted reference engine's arrays -> port objects.

SP-DTW has no weights in the neural sense; its fitted state is the
learned support (``SparsePaths``: weights, support, counts, theta,
gamma), the block-sparse tile plan (``BlockSparsePaths``: tile, active,
slot, blocks, T, meta) and the corpus with its labels. This module turns
those arrays, handed over as numpy, into the port's objects, so a port
engine computes on exactly the support the reference computes on.

A reference engine fit with ``sketch_r > 0`` also carries its sketch
(anchors, corpus sketch, squared norms, seed, gamma): jax's threefry
draws have no torch twin, so a port engine built from that state
searches on the reference's anchors, not on its own.

``centroid_model_from_reference`` carries a fitted centroid model
(centroids, labels, medoids) across the same way,
``lm_params_from_reference`` an LM's or Whisper's parameter pytree, and
``adam_state_from_reference`` the LM trainer's optimizer state (step,
moments, master copy).

``state_from_reference`` reads the arrays off any object shaped like the
reference's ``SimilarityEngine`` (attributes ``spec``, ``T``, ``sp``,
``bsp``, ``corpus``, ``labels``) through ``numpy.asarray``; it imports
nothing of the reference package. ``engine_from_state`` builds the port
engine from such a dict of numpy arrays and plain values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import SimilarityEngine, fit
from repro_torch.core.occupancy import BlockSparsePaths, SparsePaths
from repro_torch.core.spec import MeasureSpec


def state_from_reference(engine) -> dict:
    """The fitted state of a reference engine as numpy arrays and plain
    values: {"spec": {...}, "T", "sp": {...} | None, "bsp": {...} | None,
    "corpus": array | None, "labels": array | None, "sketch": {...} |
    None}."""
    spec = {f.name: getattr(engine.spec, f.name)
            for f in dataclasses.fields(MeasureSpec)}
    sp = None
    if engine.sp is not None:
        sp = {"weights": np.asarray(engine.sp.weights, np.float32),
              "support": np.asarray(engine.sp.support, bool),
              "counts": np.asarray(engine.sp.counts, np.float32),
              "theta": float(engine.sp.theta),
              "gamma": float(engine.sp.gamma)}
    bsp = None
    if engine.bsp is not None:
        b = engine.bsp
        bsp = {"tile": int(b.tile), "active": np.asarray(b.active, bool),
               "slot": np.asarray(b.slot, np.int32),
               "blocks": np.asarray(b.blocks, np.float32), "T": int(b.T),
               "meta": np.asarray(b.plan(), np.int32)}
    sketch = None
    si = getattr(engine.index, "sketch", None)
    if si is not None:
        sketch = {"anchors": np.asarray(si.anchors, np.float32),
                  "sketch": np.asarray(si.sketch, np.float32),
                  "sq": np.asarray(si.sq, np.float32), "seed": int(si.seed),
                  "gamma": None if si.gamma is None else float(si.gamma)}
    return {"spec": spec, "T": int(engine.T), "sp": sp, "bsp": bsp,
            "corpus": None if engine.corpus is None
            else np.asarray(engine.corpus, np.float32),
            "labels": None if engine.labels is None
            else np.asarray(engine.labels), "sketch": sketch}


def sparse_paths_from_arrays(sp: dict, device) -> SparsePaths:
    """A port ``SparsePaths`` on ``device`` from the reference arrays."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return SparsePaths(weights=t(sp["weights"], torch.float32),
                       support=t(sp["support"], torch.bool),
                       counts=t(sp["counts"], torch.float32),
                       theta=float(sp["theta"]), gamma=float(sp["gamma"]))


def block_sparse_from_arrays(bsp: dict) -> BlockSparsePaths:
    """A port ``BlockSparsePaths`` (host numpy) from the reference
    arrays, plan included."""
    meta = bsp.get("meta")
    return BlockSparsePaths(
        tile=int(bsp["tile"]), active=np.asarray(bsp["active"], bool),
        slot=np.asarray(bsp["slot"], np.int32),
        blocks=np.ascontiguousarray(bsp["blocks"], np.float32),
        T=int(bsp["T"]),
        meta=None if meta is None else np.asarray(meta, np.int32))


def engine_from_state(state: dict, device=None) -> SimilarityEngine:
    """The port engine for a reference engine's fitted state (see
    ``state_from_reference``), on ``device`` (default ``cuda``)."""
    from repro_torch.core.engine import resolve_device
    spec = MeasureSpec(**state["spec"])
    sp = bsp = None
    if state.get("sp") is not None:
        sp = sparse_paths_from_arrays(state["sp"], resolve_device(device))
    if state.get("bsp") is not None:
        bsp = block_sparse_from_arrays(state["bsp"])
    sk = state.get("sketch")
    # a carried sketch replaces the port's own draw: fit without one
    eng = fit(spec if sk is None else spec.replace(sketch_r=0),
              state.get("corpus"), labels=state.get("labels"), sp=sp,
              bsp=bsp, T=state["T"], device=device)
    if sk is None:
        return eng
    from repro_torch.core.sketch import SketchIndex

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=eng.device)

    si = SketchIndex(anchors=t(sk["anchors"]), sketch=t(sk["sketch"]),
                     sq=t(sk["sq"]), seed=int(sk["seed"]),
                     gamma=sk["gamma"])
    return dataclasses.replace(
        eng, spec=spec, index=dataclasses.replace(eng.index, sketch=si))


def centroid_model_from_reference(model, device=None):
    """The port's ``cluster.CentroidModel`` for a reference one: its
    centroids, weights, gamma, labels, medoids and plan, read through
    ``numpy.asarray``, on ``device`` (default ``cuda``)."""
    from repro_torch.cluster.kmeans import CentroidModel
    from repro_torch.core.engine import resolve_device
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    bsp = None
    if getattr(model, "bsp", None) is not None:
        b = model.bsp
        bsp = block_sparse_from_arrays(dict(
            tile=b.tile, active=b.active, slot=b.slot, blocks=b.blocks,
            T=b.T, meta=b.plan()))
    return CentroidModel(
        centroids=t(model.centroids), weights=t(model.weights),
        gamma=float(model.gamma),
        labels=None if model.labels is None
        else np.asarray(model.labels, np.int32),
        medoids=None if model.medoids is None
        else np.asarray(model.medoids, np.int32), bsp=bsp)


def engine_from_reference(engine, device=None) -> SimilarityEngine:
    """``engine_from_state(state_from_reference(engine), device)``."""
    return engine_from_state(state_from_reference(engine), device)


def lm_params_from_reference(params, device=None):
    """The port's parameter pytree (LM or Whisper; also a cache pytree)
    for the reference's, each leaf read through ``numpy.asarray``, on
    ``device`` (default ``cuda``). A bfloat16 leaf (``ml_dtypes``, which
    ``torch.from_numpy`` refuses) goes through float32, which holds every
    bfloat16 value exactly; other dtypes keep theirs."""
    from repro_torch.core.engine import resolve_device
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return leaf(t)

    return walk(params)


def adam_state_from_reference(state, device=None):
    """The port's ``train.optimizer.AdamState`` for a reference one (a
    named tuple step, m, v, master; master None without a master copy):
    the step as an int, every other leaf through
    ``lm_params_from_reference``, on ``device`` (default ``cuda``)."""
    from repro_torch.train.optimizer import AdamState

    def tree(t):
        return None if t is None else lm_params_from_reference(t, device)

    return AdamState(int(np.asarray(state.step)), tree(state.m),
                     tree(state.v), tree(state.master))
