"""Deterministic synthetic token pipeline with background prefetch (the
port of ``repro.train.data``; the same numpy draws, so a batch equals the
reference's exactly).

Determinism is the fault-tolerance contract: batch(step) is a pure
function of (seed, step, arch), so a restart resumes mid-run with no data
lost or repeated (skip-ahead is asking for the right step). A daemon
thread keeps ``depth`` batches ahead. Batches are numpy arrays; the
trainer moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np


class TokenPipeline:
    def __init__(self, cfg, batch: int, seq_len: int, seed: int = 0,
                 depth: int = 2):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._next_step = 0
        self._thread: Optional[threading.Thread] = None

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of (seed, step): the skip-ahead / resume
        contract. {"tokens": (B, S_text + 1) int32}, plus "patches" (B,
        n_patches, d) float32 for a VLM (S_text = seq - n_patches) and
        "frames" (B, n_frames, d) float32 for audio."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        cfg = self.cfg
        s_text = self.seq
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "vlm":
            s_text = self.seq - cfg.n_patches
            out["patches"] = rng.normal(
                size=(self.batch, cfg.n_patches, cfg.d_model)
            ).astype(np.float32) * 0.02
        if cfg.family == "audio":
            out["frames"] = rng.normal(
                size=(self.batch, cfg.n_frames, cfg.d_model)
            ).astype(np.float32) * 0.02
        # zipf-ish marginal + markov-ish repetition: learnable structure
        base = rng.zipf(1.3, size=(self.batch, s_text + 1)) % cfg.vocab
        rep = rng.random((self.batch, s_text + 1)) < 0.3
        tok = base.copy()
        tok[:, 1:] = np.where(rep[:, 1:], tok[:, :-1], tok[:, 1:])
        out["tokens"] = tok.astype(np.int32)
        return out

    def start(self, from_step: int = 0):
        """Start the prefetch thread at ``from_step``; ``next(pipe)``
        then yields ``batch_at(from_step)``, ``batch_at(from_step + 1)``,
        ..."""
        self._next_step = from_step
        self._stop.clear()

        def work():
            s = from_step
            while not self._stop.is_set():
                try:
                    self._q.put(self.batch_at(s), timeout=0.2)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return self

    def __next__(self):
        b = self._q.get()
        self._next_step += 1
        return b

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
