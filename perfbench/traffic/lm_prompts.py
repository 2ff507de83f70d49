"""Token prompts of a served language model, made from the run's seed.

The data source of a configuration that names ``"data": "lm_prompts"``:
``prompt_tokens`` ids a prompt, uniform over the configuration's
``vocab_size``, the same length in every request, ``pool`` prompts drawn
from the seed's ``POOL`` stream. There is no train split: the model's
weights come from the seed too (``WEIGHTS``), and the comparison draws
them again from the same seed. ``probe_ids`` vocabulary ids, drawn once
from the same stream after the prompts, are the logits every answer
reports beside its tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.bench.seeds import POOL, seed_rng

# the stream of the model's weights, after ``bench/seeds.py``'s four
WEIGHTS = 4


def weight_seed(seed: int) -> int:
    """The seed of the model's ``torch.Generator`` for run seed ``seed``."""
    return int(seed_rng(seed, WEIGHTS).integers(0, 1 << 62))


def cell_data(cfg: dict, pool: int, seed: int) -> dict:
    """{"tokens" (pool, prompt_tokens) int64, "probe" (probe_ids,) int64
    sorted, "weight_seed"}."""
    rng = seed_rng(seed, POOL)
    V, P = int(cfg["vocab_size"]), int(cfg["prompt_tokens"])
    tokens = rng.integers(0, V, size=(pool, P), dtype=np.int64)
    probe = np.sort(rng.choice(V, int(cfg["probe_ids"]), replace=False))
    return {"tokens": tokens, "probe": probe.astype(np.int64),
            "weight_seed": weight_seed(seed)}


def on_device(data: dict, device) -> tuple:
    """((the probe ids on ``device``, the weight seed), the pool: a mapping
    with the prompts' tokens, one row a request)."""
    probe = torch.as_tensor(data["probe"], device=device)
    pool = {"tokens": torch.as_tensor(data["tokens"], device=device)}
    return (probe, data["weight_seed"]), pool
