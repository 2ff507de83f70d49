"""Uniform model API over the decoder-LM and encoder-decoder families (the
port of ``repro.models.registry``; ``abstract_params`` and
``param_pspecs``, the reference's sharding and dry-run members, are not
here)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from .config import ModelConfig
from . import lm, whisper


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable     # (generator) -> params on generator.device
    train_loss: Callable      # (params, batch) -> float32 scalar
    prefill: Callable         # (params, batch, S_cache) -> (h, cache)
    decode_step: Callable     # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable      # (B, S_max, device) -> cache pytree


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init_params=lambda gen: whisper.init_params(cfg, gen),
            train_loss=lambda p, b: whisper.train_loss(p, b, cfg),
            prefill=lambda p, b, S: whisper.prefill(
                p, b["frames"], b["tokens"], cfg, S),
            decode_step=lambda p, c, t, pos: whisper.decode_step(
                p, c, t, pos, cfg),
            init_cache=lambda B, S, device: whisper.init_cache(
                cfg, B, S, device=device),
        )
    return ModelAPI(
        cfg=cfg,
        init_params=lambda gen: lm.init_params(cfg, gen),
        train_loss=lambda p, b: lm.train_loss(p, b, cfg),
        prefill=lambda p, b, S: lm.prefill(
            p, b["tokens"], cfg, S, patches=b.get("patches")),
        decode_step=lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
        init_cache=lambda B, S, device: lm.init_cache(
            cfg, B, S, device=device),
    )
