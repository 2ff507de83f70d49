"""State carried across: a fitted reference engine's arrays -> port objects.

SP-DTW has no weights in the neural sense; its fitted state is the
learned support (``SparsePaths``: weights, support, counts, theta,
gamma), the block-sparse tile plan (``BlockSparsePaths``: tile, active,
slot, blocks, T, meta) and the corpus with its labels. This module turns
those arrays, handed over as numpy, into the port's objects, so a port
engine computes on exactly the support the reference computes on.

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
    "corpus": array | None, "labels": array | None}."""
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
    return {"spec": spec, "T": int(engine.T), "sp": sp, "bsp": bsp,
            "corpus": None if engine.corpus is None
            else np.asarray(engine.corpus, np.float32),
            "labels": None if engine.labels is None
            else np.asarray(engine.labels)}


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
    spec = MeasureSpec(**state["spec"])
    sp = bsp = None
    if state.get("sp") is not None:
        from repro_torch.core.engine import resolve_device
        sp = sparse_paths_from_arrays(state["sp"], resolve_device(device))
    if state.get("bsp") is not None:
        bsp = block_sparse_from_arrays(state["bsp"])
    return fit(spec, state.get("corpus"), labels=state.get("labels"),
               sp=sp, bsp=bsp, T=state["T"], device=device)


def engine_from_reference(engine, device=None) -> SimilarityEngine:
    """``engine_from_state(state_from_reference(engine), device)``."""
    return engine_from_state(state_from_reference(engine), device)
