"""Helpers shared by the serving-tier tests of the PyTorch port
(``test_torch_serving.py``, ``test_torch_monitor.py``,
``test_torch_learner.py``).

jax's threefry draws have no torch twin, so wherever a test compares a
sketch-carrying port engine with the reference, the port's anchor draw
is replaced by the reference's for the same seed, R, T and length cap.
Every fit, ``with_corpus`` and re-fit then draws what the reference
draws, so sketches, drift features and anomaly scores line up.
"""
import jax
import numpy as np
import torch

from repro.core.sketch import ANCHOR_SALT as J_SALT
from repro.core.sketch import random_anchors as j_anchors
from repro_torch.core import sketch as t_sketch


def patch_reference_anchors(monkeypatch) -> None:
    """Make the port's ``fit`` draw the reference's anchors: the seed
    passes through ``anchor_generator`` unchanged and ``random_anchors``
    draws with the reference's key for that seed."""

    def draw(seed, R, T, *, d=1, min_len=4, max_len=None, sigma=1.0):
        key = jax.random.fold_in(jax.random.PRNGKey(int(seed)), J_SALT)
        return torch.as_tensor(np.array(j_anchors(
            key, R, T, d=d, min_len=min_len, max_len=max_len,
            sigma=sigma)))

    monkeypatch.setattr(t_sketch, "anchor_generator", int)
    monkeypatch.setattr(t_sketch, "random_anchors", draw)
