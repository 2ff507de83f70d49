"""Whisper-medium style encoder-decoder backbone, audio frontend stubbed
(the port of ``repro.models.whisper``).

The frontend is a stub: callers pass precomputed frame embeddings (B,
n_frames, d). The backbone: a bidirectional encoder, a causal decoder
with cross-attention, GELU MLPs (the tanh approximation, ``jax.nn.gelu``'s
default), RoPE in place of learned positions. The parameter names and
stacked layout are the reference's. Attention without a cache goes
through ``lm.attend`` (``flash.flash_attention``); ``encode`` recomputes
each encoder layer in the backward, and ``train_loss`` each decoder
layer. Over the model ranks (an ``lm.Ctx``) the encoder, decoder and
cross attention split their heads, the MLP its ff dimension and the
embedding its vocabulary, as the reference's specs say.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (attention, chunked_cross_entropy, rematerialize,
                     rms_norm, rope)
from repro_torch.launch.mesh import all_gather_dim, local_shape

from .lm import (DTYPE, NO_CTX, _cut_piece, abstract_from_schema, as_pos,
                 act_dtype, attend, block_valid_rows, embed_tokens,
                 group_slice,
                 init_from_schema, logits_of, map_schema,
                 merged_decode_attention, positions_at, stack_schema,
                 unstack_groups, valid_rows, write_block_row, write_rows)


def _attn_block(d, H, hd, prefix=""):
    return {
        prefix + "norm": ((d,), 0.0, (None,)),
        prefix + "wq": ((d, H, hd), 0.02, (None, "model", None)),
        prefix + "wk": ((d, H, hd), 0.02, (None, "model", None)),
        prefix + "wv": ((d, H, hd), 0.02, (None, "model", None)),
        prefix + "wo": ((H, hd, d), 0.02, ("model", None, None)),
    }


def _mlp_block(d, ff):
    return {
        "norm2": ((d,), 0.0, (None,)),
        "w_up": ((d, ff), 0.02, (None, "model")),
        "w_down": ((ff, d), 0.02, ("model", None)),
    }


def whisper_schema(cfg: ModelConfig):
    """{path: (shape, scale, pspec)}, the pspecs the reference's as
    tuples."""
    d, H, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    enc_layer = {**_attn_block(d, H, hd), **_mlp_block(d, ff)}
    dec_layer = {**_attn_block(d, H, hd),
                 **_attn_block(d, H, hd, prefix="x_"),
                 **_mlp_block(d, ff)}
    return {
        "embed": ((cfg.vocab, d), 0.02, ("model", None)),
        "enc_groups": [stack_schema(enc_layer, cfg.n_enc_layers)],
        "enc_norm": ((d,), 0.0, (None,)),
        "groups": [stack_schema(dec_layer, cfg.n_groups)],
        "final_norm": ((d,), 0.0, (None,)),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=DTYPE,
                layout=None):
    """Seeded parameters on ``generator.device`` (the port's own draws),
    each rank's blocks under ``layout``."""
    return init_from_schema(whisper_schema(cfg), generator, dtype, layout)


def param_pspecs(cfg: ModelConfig):
    """The partition spec of every parameter leaf, as tuples."""
    return map_schema(whisper_schema(cfg), lambda shp, sc, ps: tuple(ps))


def abstract_params(cfg: ModelConfig, dtype=DTYPE, layout=None):
    """Empty leaves of this rank's block shapes on the current device
    (``lm.abstract_params``)."""
    return abstract_from_schema(whisper_schema(cfg), dtype, layout)


def _self_attn(x, p, causal, positions, prefix="", kv_override=None,
               cache=None, pos=None, ctx=NO_CTX, cspec=None):
    """Shared attention block; ``kv_override`` is the encoder memory
    (cross-attention, no RoPE). With a cache (decode) k and v are written
    at ``pos`` in place. Returns (out, self cache or None).

    Over the model ranks every projection is split over heads: the
    normed input and the encoder memory enter through ``ctx.copy``, each
    rank attends with its heads, and ``wo``'s row-split product is cast
    and summed over the ranks. A decode self cache splits its sequence
    (``cspec``): q and the new row are gathered to every head, the owner
    of ``pos`` writes it, the ranks' attention is merged, and the rank's
    heads go on to ``wo``."""
    xn = ctx.copy(rms_norm(x, p[prefix + "norm"]))
    q = torch.einsum("bsd,dhk->bshk", xn, p[prefix + "wq"])
    src = ctx.copy(kv_override) if kv_override is not None else xn
    k = torch.einsum("bsd,dhk->bshk", src, p[prefix + "wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p[prefix + "wv"])
    if kv_override is None:  # RoPE only for self-attention
        q = rope(q, positions, 10_000.0)
        kpos = (torch.arange(src.shape[1], device=x.device) if cache is None
                else positions)
        k = rope(k, kpos, 10_000.0)
    if cache is not None:                      # decode: append + full cache
        group, n, r = ctx.split_of(cspec, 2)
        S_loc = cache["k"].shape[1]
        if group is None and ctx.tp == 1:
            write_rows(cache["k"], k, pos)
            write_rows(cache["v"], v, pos)
            kv_len = valid_rows(pos, S_loc, x.shape[0])
            o = attention(q, cache["k"], cache["v"], causal=False,
                          kv_len=kv_len)
        else:
            q, k, v = (ctx.gather(t, 2) for t in (q, k, v))
            write_block_row(cache["k"], k, pos, r)
            write_block_row(cache["v"], v, pos, r)
            o = merged_decode_attention(
                q, cache["k"], cache["v"],
                block_valid_rows(pos, S_loc * n, r, S_loc, x.shape[0]),
                group)
            h0, hl = ctx.block(o.shape[2], "n_heads")
            o = o[:, :, h0:h0 + hl]
    else:
        o = attend(q, k, v, causal)
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p[prefix + "wo"])
    return x + ctx.reduce(out.to(x.dtype)), cache


def _mlp(x, p, ctx=NO_CTX):
    h = F.gelu((ctx.copy(rms_norm(x, p["norm2"])) @ p["w_up"]).float(),
               approximate="tanh").to(x.dtype)
    return x + ctx.reduce(h @ p["w_down"])


def encode(params, frames, cfg: ModelConfig, ctx=None):
    """frames: (B, F, d) stubbed frontend output -> encoder states; each
    layer is recomputed in the backward (the reference always
    rematerialises the encoder)."""
    ctx = NO_CTX if ctx is None else ctx
    x = frames.to(act_dtype(params))
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, gp):
        x, _ = _self_attn(x, gp, causal=False, positions=positions, ctx=ctx)
        return _mlp(x, gp, ctx)

    for gps in unstack_groups(params["enc_groups"]):
        x = rematerialize(body, x, gps[0])
    return rms_norm(x, params["enc_norm"])


def train_loss(params, batch, cfg: ModelConfig, ctx=None):
    """batch: {"frames": (B, F, d), "tokens": (B, S+1)}. The decoder's
    mean next-token cross-entropy (targets ``tokens[:, 1:]``, those < 0
    masked out): causal self-attention, cross-attention to the encoder
    states, the MLP; each decoder layer recomputed in the backward. A
    float32 scalar. Under ``ctx``'s layout the batch is this rank's rows
    (``lm.Ctx.rows``) and every leaf split over "model" this rank's
    block (heads, the MLP's ff, the vocabulary)."""
    ctx = NO_CTX if ctx is None else ctx
    enc = encode(params, batch["frames"], cfg, ctx)
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = embed_tokens(params["embed"], inp, act_dtype(params), ctx)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, gp):
        x, _ = _self_attn(x, gp, causal=True, positions=positions, ctx=ctx)
        x, _ = _self_attn(x, gp, causal=False, positions=positions,
                          prefix="x_", kv_override=enc, ctx=ctx)
        return _mlp(x, gp, ctx)

    for gps in unstack_groups(params["groups"]):
        x = rematerialize(body, x, gps[0])
    x = rms_norm(x, params["final_norm"])
    mask = (tgt >= 0).float()
    return chunked_cross_entropy(x, params["embed"], torch.clamp_min(tgt, 0),
                                 mask, ctx=ctx)


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=DTYPE, *,
               device, layout=None):
    """Self-attention cache of S_max rows and an all-zero cross cache of
    n_frames rows (``prefill`` fills it from the encoder); under
    ``layout`` this rank's block of each (``launch.shapes.cache_pspecs``:
    the self cache's sequence and the cross cache's heads split)."""
    G, H, hd = cfg.n_groups, cfg.n_heads, cfg.head_dim
    specs = None
    if layout is not None:
        from repro_torch.launch.shapes import cache_pspecs
        specs = cache_pspecs(cfg, B, layout)

    def z(part, name, s):
        shape = (G, B, s, H, hd)
        if specs is not None:
            shape = local_shape(shape, specs[part][name], layout)
        return torch.zeros(shape, dtype=dtype, device=device)

    return {part: {n: z(part, n, s) for n in ("k", "v")}
            for part, s in (("self", S_max), ("cross", cfg.n_frames))}


def prefill(params, frames, tokens, cfg: ModelConfig, S_cache: int,
            ctx=None):
    """Encode audio and consume the prompt; returns (last hidden, cache):
    the self cache padded to S_cache rows, the cross cache the encoder's
    keys and values. Under ``ctx``'s layout the inputs are the global
    batch and the cache this rank's block of it (the self cache's
    sequence split, the cross cache this rank's heads)."""
    ctx = NO_CTX if ctx is None else ctx
    specs = None
    if ctx.layout is not None:
        from repro_torch.launch.shapes import cache_pspecs
        specs = cache_pspecs(cfg, tokens.shape[0], ctx.layout)
    rows_group = None
    if specs is not None and ctx.split_of(specs["self"]["k"], 1)[1] > 1:
        frames, tokens = ctx.rows(frames), ctx.rows(tokens)
        rows_group = ctx.dp_group()
    enc = encode(params, frames, cfg, ctx)
    B, S = tokens.shape
    x = embed_tokens(params["embed"], tokens, act_dtype(params), ctx)
    positions = torch.arange(S, device=x.device)
    pad = S_cache - S
    caches = {"self": {"k": [], "v": []}, "cross": {"k": [], "v": []}}
    for g in range(cfg.n_groups):
        gp = group_slice(params["groups"][0], g)
        xn = rms_norm(x, gp["norm"])
        k = rope(torch.einsum("bsd,dhk->bshk", xn, gp["wk"]), positions,
                 10_000.0)
        v = torch.einsum("bsd,dhk->bshk", xn, gp["wv"])
        # the self cache holds every head: this rank's are gathered
        caches["self"]["k"].append(F.pad(ctx.gather(k, 2),
                                         (0, 0, 0, 0, 0, pad)))
        caches["self"]["v"].append(F.pad(ctx.gather(v, 2),
                                         (0, 0, 0, 0, 0, pad)))
        caches["cross"]["k"].append(
            torch.einsum("bsd,dhk->bshk", enc, gp["x_wk"]))
        caches["cross"]["v"].append(
            torch.einsum("bsd,dhk->bshk", enc, gp["x_wv"]))
        x, _ = _self_attn(x, gp, causal=True, positions=positions, ctx=ctx)
        x, _ = _self_attn(x, gp, causal=False, positions=positions,
                          prefix="x_", kv_override=enc, ctx=ctx)
        x = _mlp(x, gp, ctx)
    x = rms_norm(x, params["final_norm"])
    cache = {part: {k: torch.stack(v) for k, v in kv.items()}
             for part, kv in caches.items()}
    if specs is not None:
        cache["self"] = {k: _cut_piece(v, specs["self"][k], ctx, (2,))
                         for k, v in cache["self"].items()}
    return all_gather_dim(x[:, -1, :].contiguous(), rows_group, 0), cache


def decode_step(params, cache, token, pos, cfg: ModelConfig, ctx=None):
    """token: (B, 1) int; pos an int or a 0-d tensor.
    Returns (logits (B, V) float32, cache), the self cache updated in
    place; cross-attention reads the cache's static encoder keys and
    values. Under ``ctx``'s layout ``cache`` is this rank's block
    (``init_cache(..., layout=)``), ``token`` the global batch and the
    logits whole on every rank."""
    ctx = NO_CTX if ctx is None else ctx
    pos = as_pos(pos, token.device)
    specs, rows_group = None, None
    if ctx.layout is not None:
        from repro_torch.launch.shapes import cache_pspecs
        specs = cache_pspecs(cfg, token.shape[0], ctx.layout)
        if ctx.split_of(specs["self"]["k"], 1)[1] > 1:
            token, rows_group = ctx.rows(token), ctx.dp_group()
    x = embed_tokens(params["embed"], token, act_dtype(params), ctx)
    positions = positions_at(pos, 1)
    for g in range(cfg.n_groups):
        gp = group_slice(params["groups"][0], g)
        x, _ = _self_attn(x, gp, causal=False, positions=positions,
                          cache=group_slice(cache["self"], g), pos=pos,
                          ctx=ctx,
                          cspec=None if specs is None else specs["self"]["k"])
        xn = ctx.copy(rms_norm(x, gp["x_norm"]))
        q = torch.einsum("bsd,dhk->bshk", xn, gp["x_wq"])
        cc = group_slice(cache["cross"], g)
        o = attention(q, cc["k"], cc["v"], causal=False)
        out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), gp["x_wo"])
        x = x + ctx.reduce(out.to(x.dtype))
        x = _mlp(x, gp, ctx)
    x = rms_norm(x, params["final_norm"])
    logits = logits_of(params, x[:, 0, :], ctx)
    return all_gather_dim(logits, rows_group, 0), cache
