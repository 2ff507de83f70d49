"""Uniform model API over the decoder-LM and encoder-decoder families (the
port of ``repro.models.registry``)."""
from __future__ import annotations

import dataclasses
from typing import Callable

from .config import ModelConfig
from . import lm, whisper


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init_params: Callable     # (generator, layout=None) -> params
    abstract_params: Callable  # (dtype=bf16, layout=None) -> empty leaves
    param_pspecs: Callable    # () -> partition spec tuples, leaf for leaf
    train_loss: Callable      # (params, batch, ctx=None) -> float32 scalar
    prefill: Callable         # (params, batch, S_cache, ctx=None) -> (h, cache)
    decode_step: Callable     # (params, cache, token, pos, ctx=None)
                              #   -> (logits, cache)
    init_cache: Callable      # (B, S_max, device, layout=None) -> cache


def _init(fn, cfg):
    """``init_params(generator, layout=None)``: the one-device call stays
    ``fn(cfg, generator)``, a layout is passed on."""
    def init(gen, layout=None):
        if layout is None:
            return fn(cfg, gen)
        return fn(cfg, gen, layout=layout)
    return init


def _with(fn, *args, **named):
    """``fn(*args)``, with each keyword of ``named`` passed only where it
    is given (not None): the one-device call stays as it was."""
    return fn(*args, **{k: v for k, v in named.items() if v is not None})


def build(cfg: ModelConfig) -> ModelAPI:
    if cfg.family == "audio":
        return ModelAPI(
            cfg=cfg,
            init_params=_init(whisper.init_params, cfg),
            abstract_params=lambda dtype=whisper.DTYPE, layout=None:
                whisper.abstract_params(cfg, dtype, layout),
            param_pspecs=lambda: whisper.param_pspecs(cfg),
            train_loss=lambda p, b, ctx=None: whisper.train_loss(
                p, b, cfg, ctx),
            prefill=lambda p, b, S, ctx=None: _with(
                whisper.prefill, p, b["frames"], b["tokens"], cfg, S,
                ctx=ctx),
            decode_step=lambda p, c, t, pos, ctx=None: _with(
                whisper.decode_step, p, c, t, pos, cfg, ctx=ctx),
            init_cache=lambda B, S, device, layout=None: _with(
                whisper.init_cache, cfg, B, S, device=device,
                layout=layout),
        )
    return ModelAPI(
        cfg=cfg,
        init_params=_init(lm.init_params, cfg),
        abstract_params=lambda dtype=lm.DTYPE, layout=None:
            lm.abstract_params(cfg, dtype, layout),
        param_pspecs=lambda: lm.param_pspecs(cfg),
        train_loss=lambda p, b, ctx=None: lm.train_loss(p, b, cfg, ctx),
        prefill=lambda p, b, S, ctx=None: _with(
            lm.prefill, p, b["tokens"], cfg, S, patches=b.get("patches"),
            ctx=ctx),
        decode_step=lambda p, c, t, pos, ctx=None: _with(
            lm.decode_step, p, c, t, pos, cfg, ctx=ctx),
        init_cache=lambda B, S, device, layout=None: _with(
            lm.init_cache, cfg, B, S, device=device, layout=layout),
    )
