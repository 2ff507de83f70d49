"""Versioned engine snapshots: the learner/actor publication point.

The serving tier answers from a *frozen* ``SimilarityEngine``: every
exactness argument of the cascade (admissible bounds, strict abandoning,
the pruned DP) assumes the corpus index it reads was built in one piece.
Continuous fitting behind live serving therefore never mutates the
serving engine. This module is the seam that keeps the proofs intact:

  * ``EngineSnapshot`` wraps one fully built engine behind a
    monotonically increasing integer ``version``, the unit of
    publication. Nothing downstream of ``publish`` changes it.
  * ``SnapshotStore`` is the single handoff cell between one background
    learner (writer) and any number of serving actors (readers).
    ``publish`` builds the stamped snapshot first and then installs it
    with one reference assignment, atomic under the interpreter, so a
    concurrent reader sees either the old snapshot or the new one,
    never a mix. ``current()`` is wait-free: one attribute read.

An engine is a frozen record of tensors that nothing writes after
``fit``, so publication costs one pointer swap whatever the corpus size.
On a CUDA card the writer must have finished the work that fills those
tensors before it publishes: ``launch.learner.Learner`` synchronises its
own stream first, so a reader on another stream never reads an index
that is still being written.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

from .engine import SimilarityEngine


@dataclasses.dataclass(frozen=True)
class EngineSnapshot:
    """One published engine state: the unit the learner hands to actors.

    engine:   a fully fitted frozen ``SimilarityEngine`` (corpus, index,
              sketch and centroid model all built before publication);
    version:  monotonically increasing publication stamp, equal to
              ``engine.version`` (the store enforces both);
    step:     the learner step that produced this snapshot (0 for the
              initial fit), so a run can report snapshot cadence.
    """
    engine: SimilarityEngine
    version: int
    step: int = 0

    @property
    def corpus_size(self) -> int:
        """Number of corpus series in this snapshot's engine."""
        return self.engine.corpus_size


class SnapshotStore:
    """Atomic, versioned publication cell between learner and actors.

    One writer (the learner) calls ``publish``; any number of readers
    (serving actors) call ``current``. The store owns the version
    counter: every publication is restamped ``current.version + 1``, so
    versions are monotone by construction whatever version the handed-in
    engine carries. A lock serialises writers; readers never take it, so
    serving latency does not depend on refresh activity.

    ``keep_history=True`` keeps every published snapshot (the initial one
    included) in ``history``: the replay surface of the snapshot tests
    and of the refresh scenario's exactness checks. Serving never reads
    it.
    """

    def __init__(self, engine: SimilarityEngine, *,
                 keep_history: bool = False):
        v = int(engine.version)
        snap = EngineSnapshot(engine=engine, version=v, step=0)
        self._lock = threading.Lock()
        self._snap = snap
        self._n_published = 0
        self._keep_history = bool(keep_history)
        self.history: List[EngineSnapshot] = [snap] if keep_history else []

    @property
    def version(self) -> int:
        """Version stamp of the installed snapshot."""
        return self._snap.version

    @property
    def n_published(self) -> int:
        """Number of ``publish`` calls since construction (the initial
        snapshot does not count)."""
        return self._n_published

    def current(self) -> EngineSnapshot:
        """The installed snapshot: wait-free, never torn (one reference
        read; the snapshot behind it is immutable)."""
        return self._snap

    def publish(self, engine: SimilarityEngine, *,
                step: Optional[int] = None) -> EngineSnapshot:
        """Install ``engine`` as the next snapshot and return it.

        The engine is restamped ``version = current.version + 1`` and
        wrapped before the swap; the swap itself is one reference
        assignment. ``step`` defaults to the previous snapshot's
        step + 1.
        """
        with self._lock:
            prev = self._snap
            v = prev.version + 1
            snap = EngineSnapshot(
                engine=dataclasses.replace(engine, version=v),
                version=v,
                step=prev.step + 1 if step is None else int(step))
            if self._keep_history:
                self.history.append(snap)
            self._n_published += 1
            self._snap = snap          # the one atomic pointer swap
        return snap
