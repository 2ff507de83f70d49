"""Background learner: continuous fitting behind live serving.

The learner/actor split: serving actors answer every query from a frozen
``SimilarityEngine`` snapshot while this learner consumes the arrival
stream and produces the *next* snapshot off the serving path. One
``Learner.step`` is one refresh:

  1. **Corpus growth**: the next mini-batch of arrivals is appended and
     ``SimilarityEngine.with_corpus`` rebuilds every per-candidate index
     artifact (LB_Keogh envelopes, sketch rows) on the grown corpus. The
     rebuild is deterministic from ``spec.seed``: a refreshed sketch
     equals a fresh fit's on the same support, so the shortlist and
     bound arguments hold for the new snapshot as for the initial one.
  2. **Centroid refresh**: when the serving engine carries a
     ``CentroidModel``, each centroid takes ``centroid_steps``
     warm-started Adam steps of the soft-SP-DTW barycenter objective
     (``cluster.barycenter.soft_barycenter``: K8 / K9 on the card) over
     its arriving members (by label when the stream is labelled, by hard
     nearest-centroid assignment otherwise).
  3. **Support-occupancy update**: optimal-path occupancy counts of the
     arrival batch accumulate on the learner
     (``core.occupancy.pairwise_path_counts``); every ``support_every``
     steps (opt-in), or when a ``drift_monitor`` fires on the batch's
     sketch features, the support is re-learned from the combined counts
     and the engine is re-fit from the spec. A learner with neither
     skips the counts, which nothing would read.
  4. **Swap-on-converge**: only once the new engine is fully built is it
     handed to ``core.snapshot.SnapshotStore.publish``: one restamped,
     monotone-versioned pointer swap.

Everything a step computes is a function of (initial engine, arrival
stream, config), so a fixed seed reproduces the snapshot sequence.
``start()`` / ``stop()`` / ``join()`` run the same ``step`` loop in a
daemon thread. On a CUDA card that thread launches its kernels on a
stream of its own, so a refresh does not queue in front of the serving
batches, and synchronises that stream before each publication, so a
reader never adopts an index whose tensors are still being written. A
failure in the thread is kept and raised by ``join`` / ``stop``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.engine import fit
from repro_torch.core.occupancy import learn_sparse_paths, pairwise_path_counts
from repro_torch.core.snapshot import EngineSnapshot, SnapshotStore


class Learner:
    """Consumes an arrival stream and publishes versioned engine
    snapshots to a ``SnapshotStore``.

    store:          the publication cell shared with the serving actors
                    (its current snapshot seeds the first refresh).
    arrivals:       (Na, T[, d]) stream of arriving series (an array or a
                    tensor on any device; kept on the host and moved to
                    the engine's device a mini-batch at a time).
    labels:         optional (Na,) labels riding with the arrivals
                    (required when the initial engine carries labels).
    batch:          arrivals consumed per ``step``.
    centroid_steps: warm-started Adam steps per centroid refresh (0
                    disables centroid refresh even when a model is fit).
    lr:             Adam step size of the centroid refresh.
    support_every:  re-learn the support from the accumulated occupancy
                    counts every N steps (None/0 disables, the default).
    drift_monitor:  optional ``repro_torch.monitor.DriftMonitor``: each
                    consumed batch's sketch features update its window,
                    and a trigger forces the support re-learn on that
                    step. ``n_support_refreshes`` counts the re-learns.
    impl:           backend for fitting-time evaluation.
    """

    def __init__(self, store: SnapshotStore, arrivals, labels=None, *,
                 batch: int = 8, centroid_steps: int = 4, lr: float = 0.05,
                 support_every: Optional[int] = None, drift_monitor=None,
                 impl: str = "auto"):
        self.store = store
        if isinstance(arrivals, torch.Tensor):
            arrivals = arrivals.detach().cpu().numpy()
        self.arrivals = np.asarray(arrivals, np.float32)
        self.labels = None if labels is None else np.asarray(labels)
        if self.labels is not None and \
                len(self.labels) != len(self.arrivals):
            raise ValueError("arrival labels must match the arrival stream "
                             "length")
        base = store.current().engine
        if base.labels is not None and self.labels is None:
            raise ValueError("the serving engine carries labels; the "
                             "arrival stream must too (or classify would "
                             "break on the first refresh)")
        self.batch = int(batch)
        if self.batch <= 0:
            raise ValueError("batch must be positive")
        self.centroid_steps = int(centroid_steps)
        self.lr = float(lr)
        self.support_every = int(support_every) if support_every else 0
        self.drift = drift_monitor
        self.n_support_refreshes = 0
        self.impl = impl
        self.snapshots: List[EngineSnapshot] = []
        self._pos = 0
        self._step_i = 0
        self._counts = None            # accumulated occupancy counts
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._error: Optional[Exception] = None

    # ---- stream bookkeeping ----------------------------------------------
    @property
    def pending(self) -> int:
        """Arrivals not yet consumed."""
        return len(self.arrivals) - self._pos

    @property
    def exhausted(self) -> bool:
        """True once the whole arrival stream has been consumed."""
        return self._pos >= len(self.arrivals)

    # ---- one refresh ------------------------------------------------------
    def _refresh_centroids(self, model, batch: torch.Tensor,
                           batch_labels: Optional[np.ndarray]):
        """Mini-batch centroid refresh: warm-started barycenter steps per
        centroid over its arriving members (by label when the stream is
        labelled, by hard nearest-centroid assignment otherwise).
        Centroids with no arriving members are untouched."""
        from repro_torch.cluster import nearest_centroid
        from repro_torch.cluster.barycenter import soft_barycenter
        if batch_labels is not None and model.labels is not None:
            mlab = np.asarray(model.labels)
            owner = np.asarray([int(np.argmax(mlab == lab))
                                if (mlab == lab).any() else -1
                                for lab in batch_labels])
        else:
            idx, _ = nearest_centroid(batch, model, impl=self.impl)
            owner = idx.cpu().numpy()
        Z = model.centroids.clone()
        for c in range(model.k):
            sel = np.nonzero(owner == c)[0]
            if len(sel) == 0:
                continue
            members = batch[torch.as_tensor(sel, device=batch.device)]
            zc, _ = soft_barycenter(members, model.weights, model.gamma,
                                    init=Z[c], steps=self.centroid_steps,
                                    lr=self.lr, bsp=model.bsp)
            Z[c] = zc
        return dataclasses.replace(model, centroids=Z)

    def step(self) -> Optional[EngineSnapshot]:
        """Consume one arrival mini-batch, build the next engine, and
        publish it. Returns the published snapshot, or None when the
        stream is exhausted."""
        if self.exhausted:
            return None
        lo, hi = self._pos, min(self._pos + self.batch, len(self.arrivals))
        self._pos = hi
        self._step_i += 1
        base = self.store.current().engine
        if base.corpus is None:
            raise ValueError("the learner refreshes a fitted corpus; fit "
                             "one first")
        dev = base.device
        batch = torch.as_tensor(self.arrivals[lo:hi], device=dev)
        blab = None if self.labels is None else self.labels[lo:hi]
        corpus2 = torch.cat([base.corpus, batch], dim=0)
        labels2 = None
        if base.labels is not None:
            labels2 = np.concatenate([np.asarray(base.labels), blab])
        # ---- drift trigger: sketch the arrival batch and let a
        # calibrated shift force the support re-learn ---------------------
        drift_fired = False
        if self.drift is not None and base.index is not None and \
                base.index.sketch is not None:
            feats = base.sketch_embed(batch, impl=self.impl)
            drift_fired = bool(self.drift.update(feats))
        # ---- support-occupancy update (accumulate; refresh when due).
        # The counts are read only by a re-learn, so a learner that can
        # never re-learn skips them: they are the step's largest cost
        # (an unfused DP and backtrack over the batch's pairs, host-bound
        # launches that hold the interpreter lock serving needs) ---------
        refresh_support = False
        if base.spec.support == "learned" and batch.shape[0] > 1 and \
                (self.support_every > 0 or self.drift is not None):
            c = pairwise_path_counts(batch)
            self._counts = c if self._counts is None else self._counts + c
            refresh_support = (self.support_every > 0 and
                               self._step_i % self.support_every == 0) or \
                drift_fired
        if refresh_support:
            self.n_support_refreshes += 1
            # rare, deliberate: re-threshold the combined counts and re-fit
            # from the spec (new support, new plan)
            counts = self._counts if base.sp is None else \
                base.sp.counts.to(dev) + self._counts
            sp2 = learn_sparse_paths(batch, theta=base.spec.theta,
                                     gamma=base.spec.weight_gamma,
                                     counts=counts)
            eng2 = fit(base.spec, corpus2, labels=labels2, sp=sp2,
                       device=dev)
            eng2 = dataclasses.replace(eng2, version=base.version + 1)
        else:
            eng2 = base.with_corpus(corpus2, labels2)
        # ---- mini-batch centroid refresh --------------------------------
        if base.centroid_model is not None and self.centroid_steps > 0:
            model = self._refresh_centroids(base.centroid_model, batch, blab)
            eng2 = dataclasses.replace(eng2, centroid_model=model)
        elif base.centroid_model is not None:
            eng2 = dataclasses.replace(eng2,
                                       centroid_model=base.centroid_model)
        # ---- swap-on-converge: the new engine's tensors are written
        # before any reader can adopt it ----------------------------------
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        snap = self.store.publish(eng2, step=self._step_i)
        self.snapshots.append(snap)
        return snap

    def drain(self, max_steps: Optional[int] = None
              ) -> List[EngineSnapshot]:
        """Run ``step`` until the stream is exhausted (or ``max_steps``
        publications happened); returns the snapshots this call
        published."""
        out: List[EngineSnapshot] = []
        while not self.exhausted:
            if max_steps is not None and len(out) >= max_steps:
                break
            snap = self.step()
            if snap is None:
                break
            out.append(snap)
        return out

    # ---- background (threaded) mode --------------------------------------
    def start(self, interval_s: float = 0.0) -> None:
        """Run the refresh loop in a daemon thread until the stream drains
        or ``stop()`` is called; ``interval_s`` sleeps between steps.
        Serving keeps answering from the store's current snapshot
        throughout.

        On a CUDA card the kernel libraries are built and loaded here, in
        the calling thread (their loader is a cache, not a lock), the
        thread's work runs on a new stream, and that stream first waits
        for the caller's stream, which produced the engine it starts
        from."""
        if self._thread is not None:
            raise RuntimeError("learner already started")
        self._stop.clear()
        self._error = None
        dev = self.store.current().engine.device
        on_stream = contextlib.nullcontext()
        if dev.type == "cuda":
            from repro_torch.kernels import _build
            for name in _build.SIGNATURES:
                _build.library(name)
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            on_stream = torch.cuda.stream(stream)

        def loop():
            try:
                with on_stream:
                    while not self._stop.is_set() and not self.exhausted:
                        self.step()
                        if interval_s > 0:
                            self._stop.wait(interval_s)
            except Exception as e:   # kept for join / stop to raise
                self._error = e

        self._thread = threading.Thread(target=loop, name="repro-learner",
                                        daemon=True)
        self._thread.start()

    def _raise_failure(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("the learner thread failed") from err

    def stop(self, timeout: float = 60.0) -> None:
        """Signal the background loop to stop and join it; raises when
        the thread failed or did not stop. Idempotent; a no-op when
        ``start`` was never called."""
        if self._thread is None:
            self._raise_failure()
            return
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("learner thread failed to stop")
        self._thread = None
        self._raise_failure()

    def join(self, timeout: float = 600.0) -> None:
        """Wait for the background loop to drain the arrival stream (it
        exits on its own once ``exhausted``); raises when the thread
        failed."""
        if self._thread is None:
            self._raise_failure()
            return
        t0 = time.time()
        while self._thread.is_alive() and not self.exhausted:
            if time.time() - t0 > timeout:
                raise TimeoutError("learner did not drain in time")
            time.sleep(0.01)
        self.stop(timeout=max(1.0, timeout - (time.time() - t0)))
