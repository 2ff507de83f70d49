"""Serve-step factories (the port of ``repro.train.train_step``'s
``make_serve_step`` and ``make_prefill``). Both run under
``torch.inference_mode()``."""
from __future__ import annotations

import torch


def make_serve_step(api):
    """One greedy decode step: (params, cache, token, pos) -> (next token
    (B, 1), cache). The argmax takes the first index among equal logits."""

    def step(params, cache, token, pos):
        with torch.inference_mode():
            logits, new_cache = api.decode_step(params, cache, token, pos)
            return torch.argmax(logits, dim=-1)[:, None], new_cache

    return step


def make_prefill(api, S_cache: int):
    """(params, batch) -> (last hidden, cache)."""

    def prefill(params, batch):
        with torch.inference_mode():
            return api.prefill(params, batch, S_cache)

    return prefill
