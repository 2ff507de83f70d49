"""Uniform model API over the decoder-LM and encoder-decoder families (the
port of ``repro.models.registry``; ``abstract_params``, the reference's
dry-run member, is not here)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from .config import ModelConfig
from . import lm, whisper


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable     # (generator, layout=None) -> params
    param_pspecs: Callable    # () -> partition spec tuples, leaf for leaf
    train_loss: Callable      # (params, batch, ctx=None) -> float32 scalar
    prefill: Callable         # (params, batch, S_cache) -> (h, cache)
    decode_step: Callable     # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable      # (B, S_max, device) -> cache pytree


def _init(fn, cfg):
    """``init_params(generator, layout=None)``: the one-device call stays
    ``fn(cfg, generator)``, a layout is passed on."""
    def init(gen, layout=None):
        if layout is None:
            return fn(cfg, gen)
        return fn(cfg, gen, layout=layout)
    return init


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init_params=_init(whisper.init_params, cfg),
            param_pspecs=lambda: whisper.param_pspecs(cfg),
            train_loss=lambda p, b, ctx=None: whisper.train_loss(
                p, b, cfg, ctx),
            prefill=lambda p, b, S: whisper.prefill(
                p, b["frames"], b["tokens"], cfg, S),
            decode_step=lambda p, c, t, pos: whisper.decode_step(
                p, c, t, pos, cfg),
            init_cache=lambda B, S, device: whisper.init_cache(
                cfg, B, S, device=device),
        )
    return ModelAPI(
        cfg=cfg,
        init_params=_init(lm.init_params, cfg),
        param_pspecs=lambda: lm.param_pspecs(cfg),
        train_loss=lambda p, b, ctx=None: lm.train_loss(p, b, cfg, ctx),
        prefill=lambda p, b, S: lm.prefill(
            p, b["tokens"], cfg, S, patches=b.get("patches")),
        decode_step=lambda p, c, t, pos: lm.decode_step(p, c, t, pos, cfg),
        init_cache=lambda B, S, device: lm.init_cache(
            cfg, B, S, device=device),
    )
