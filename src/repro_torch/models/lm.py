"""Generic decoder LM covering dense / GQA, MLA + MoE, Mamba, hybrid and VLM
architectures (the port of ``repro.models.lm``).

Parameter pytree, the reference's names and layout:
  { "embed": (V, d), "final_norm": (d,),
    "groups": [ per-pattern-position dict, every leaf stacked (G, ...) ] }

Entry points:
  train_loss(params, batch, cfg)              -> scalar loss
  forward_hidden(params, tokens, cfg)         -> (final hidden, aux loss)
  prefill(params, tokens, cfg, S_cache)       -> (last hidden, cache)
  decode_step(params, cache, token, pos, cfg) -> (logits, cache)

The reference scans over the groups; here a Python loop indexes the
stacked leaves. Its sharding constraints and barriers do nothing on one
card and are not carried over. Attention without a cache goes through
``flash.flash_attention`` (its forward is ``layers.attention``'s, its
backward recomputes the probabilities), as in the reference.
``forward_hidden`` rematerialises each group in the backward
(``layers.rematerialize``, the reference's ``jax.checkpoint``).
``decode_step`` writes the new KV rows and states into the cache it is
given (the reference donates its cache) and returns it; nothing on the
training path writes in place into a tensor autograd keeps.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.pytree import tree_leaves, tree_map

from .config import LayerSpec, ModelConfig
from .flash import flash_attention
from .layers import (attention, chunked_cross_entropy, gated_mlp,
                     rematerialize, rms_norm, rope)
from .mamba import init_mamba_state, mamba_decode_step, mamba_mixer
from .moe import moe_ffn

DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# parameter schema: name -> (shape, init scale)
# --------------------------------------------------------------------------

def _attn_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "norm1": ((d,), 0.0),
        "wq": ((d, H, hd), 0.02),
        "wk": ((d, Hkv, hd), 0.02),
        "wv": ((d, Hkv, hd), 0.02),
        "wo": ((H, hd, d), 0.02),
    }


def _mla_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, H = cfg.d_model, cfg.n_heads
    hd, rhd, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    out = {
        "norm1": ((d,), 0.0),
        "w_dkv": ((d, r), 0.02),
        "kv_norm": ((r,), 0.0),
        "w_krope": ((d, rhd), 0.02),
        "w_uk": ((r, H, hd), 0.02),
        "w_uv": ((r, H, dv), 0.02),
        "wo": ((H, dv, d), 0.02),
    }
    if cfg.q_lora_rank:
        out.update({
            "w_dq": ((d, cfg.q_lora_rank), 0.02),
            "q_norm": ((cfg.q_lora_rank,), 0.0),
            "w_uq": ((cfg.q_lora_rank, H, hd), 0.02),
            "w_uq_rope": ((cfg.q_lora_rank, H, rhd), 0.02),
        })
    else:
        out.update({
            "w_q": ((d, H, hd), 0.02),
            "w_q_rope": ((d, H, rhd), 0.02),
        })
    return out


def _mamba_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = max(d // 16, 1)
    return {
        "norm1": ((d,), 0.0),
        "in_x": ((d, di), 0.02),
        "in_z": ((d, di), 0.02),
        "conv_w": ((cfg.d_conv, di), 0.02),
        "conv_b": ((di,), 0.0),
        "w_B": ((di, ds), 0.02),
        "w_C": ((di, ds), 0.02),
        "dt_down": ((di, dtr), 0.02),
        "dt_up": ((dtr, di), 0.02),
        "dt_bias": ((di,), 0.0),
        "A_log": ((di, ds), 0.0),
        "D": ((di,), 0.0),
        "out": ((di, d), 0.02),
    }


def _mlp_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "norm2": ((d,), 0.0),
        "w_gate": ((d, ff), 0.02),
        "w_up": ((d, ff), 0.02),
        "w_down": ((ff, d), 0.02),
    }


def _moe_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out = {
        "norm2": ((d,), 0.0),
        "router": ((d, E), 0.02),
        "gate": ((E, d, ff), 0.02),
        "up": ((E, d, ff), 0.02),
        "down": ((E, ff, d), 0.02),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        out.update({
            "sh_gate": ((d, sff), 0.02),
            "sh_up": ((d, sff), 0.02),
            "sh_down": ((sff, d), 0.02),
        })
    return out


def layer_schema(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    if spec.mixer == "attn":
        out.update(_attn_schema(cfg))
    elif spec.mixer == "mla":
        out.update(_mla_schema(cfg))
    elif spec.mixer == "mamba":
        out.update(_mamba_schema(cfg))
    if spec.ffn == "mlp":
        out.update(_mlp_schema(cfg))
    elif spec.ffn == "moe":
        out.update(_moe_schema(cfg))
    return out


def model_schema(cfg: ModelConfig):
    """Full-pytree schema {path: (shape, scale)}, mirroring the params."""
    groups = []
    for spec in cfg.pattern:
        groups.append({k: ((cfg.n_groups,) + shp, sc)
                       for k, (shp, sc) in layer_schema(cfg, spec).items()})
    return {
        "embed": ((cfg.vocab, cfg.d_model), 0.02),
        "final_norm": ((cfg.d_model,), 0.0),
        "groups": groups,
    }


def map_schema(schema, fn):
    """Apply ``fn(shape, scale)`` to every leaf of a schema (dicts and
    lists of dicts, in insertion order)."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, list):
            out[k] = [{kk: fn(*vv) for kk, vv in g.items()} for g in v]
        else:
            out[k] = fn(*v)
    return out


# elements drawn per float32 chunk: keeps the transient at 1 GiB however
# large a stacked leaf is
_DRAW_CHUNK = 1 << 28


def draw_leaf(shape, scale: float, generator: torch.Generator, dtype):
    """One leaf on the generator's device: zeros where the scale is 0,
    else normal draws times the scale, drawn in float32 chunks and cast."""
    out = torch.zeros(shape, dtype=dtype, device=generator.device)
    if scale == 0.0:
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), _DRAW_CHUNK):
        n = min(_DRAW_CHUNK, flat.numel() - i)
        flat[i:i + n] = (torch.randn(n, generator=generator,
                                     device=generator.device) * scale
                         ).to(dtype)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=DTYPE):
    """Seeded parameters on ``generator.device``; the reference's
    ``fold_in`` draws have no torch twin, so the values are the port's
    own (``convert.lm_params_from_reference`` carries the reference's)."""
    return map_schema(model_schema(cfg),
                      lambda shp, sc: draw_leaf(shp, sc, generator, dtype))


def param_bytes(tree) -> int:
    """Bytes of every leaf of a parameter or cache pytree."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def group_slice(tree: dict, g: int) -> dict:
    """Group ``g``'s views of a dict of stacked (G, ...) leaves."""
    return {k: v[g] for k, v in tree.items()}


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

# A decode position is a 0-d int64 tensor on the activations' device
# (``decode_step`` converts what it is given once), so that one decode
# step can be captured in a CUDA graph and replayed at any position.

def as_pos(pos, device) -> torch.Tensor:
    """A decode position (an int or a tensor) as a 0-d int64 tensor on
    ``device``."""
    return torch.as_tensor(pos, dtype=torch.long, device=device)


def positions_at(pos: torch.Tensor, S: int) -> torch.Tensor:
    """The positions of a decode step's S new rows, all ``pos``."""
    return pos.reshape(1).expand(S)


def valid_rows(pos: torch.Tensor, S_c: int, B: int) -> torch.Tensor:
    """(B,) cache rows valid once position ``pos`` is written:
    ``min(pos + 1, S_c)``."""
    return torch.clamp(pos + 1, max=S_c).expand(B)


def write_rows(buf: torch.Tensor, rows: torch.Tensor, start: torch.Tensor):
    """Write ``rows`` into ``buf`` at sequence row ``start`` (axis 1) in
    place, the start clamped so the rows fit, as dynamic_update_slice
    does."""
    S_c, S = buf.shape[1], rows.shape[1]
    idx = torch.clamp(start, 0, S_c - S) + torch.arange(S, device=buf.device)
    buf.index_copy_(1, idx, rows)


def _apply_attn(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
                pos=None):
    """Returns (out, cache piece). Decode (cache and pos given) writes k, v
    into the cache at ``pos`` (at ``pos % S_c`` for a windowed layer's
    ring) and attends to the valid rows; otherwise the piece is the full
    roped k and v of the sequence."""
    B, S, d = x.shape
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xn, p["wv"])

    decode = cache is not None and pos is not None
    positions = (positions_at(pos, S) if decode
                 else torch.arange(S, device=x.device))
    q = rope(q, positions, spec.rope_theta)
    k = rope(k, positions, spec.rope_theta)

    if decode:
        S_c = cache["k"].shape[1]
        write = pos % S_c if spec.window is not None else pos
        write_rows(cache["k"], k, write)
        write_rows(cache["v"], v, write)
        kv_len = valid_rows(pos, S_c, B)
        o = attention(q, cache["k"], cache["v"], causal=False, kv_len=kv_len,
                      q_offset=pos, window=None)
        piece = cache
    else:
        o = flash_attention(q, k, v, True, spec.window, 0, 1024, None)
        piece = {"k": k, "v": v}
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    return x + out, piece


def _mla_qkv(xn, p, cfg: ModelConfig, positions):
    if cfg.q_lora_rank:
        cq = rms_norm(xn @ p["w_dq"], p["q_norm"], cfg.norm_eps)
        q_nope = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
        q_rope = torch.einsum("bsr,rhk->bshk", cq, p["w_uq_rope"])
    else:
        q_nope = torch.einsum("bsd,dhk->bshk", xn, p["w_q"])
        q_rope = torch.einsum("bsd,dhk->bshk", xn, p["w_q_rope"])
    q_rope = rope(q_rope, positions, 10_000.0)
    ckv = rms_norm(xn @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    krope = rope((xn @ p["w_krope"])[:, :, None, :], positions, 10_000.0)
    return q_nope, q_rope, ckv, krope[:, :, 0, :]


def _apply_mla(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
               pos=None):
    """Returns (out, cache piece): decode scores against the compressed
    cache (W_uk absorbed into q); otherwise full attention, the piece the
    sequence's ckv and roped k."""
    B, S, d = x.shape
    H, hd, rhd = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    decode = cache is not None and pos is not None
    positions = (positions_at(pos, S) if decode
                 else torch.arange(S, device=x.device))
    q_nope, q_rope, ckv, krope = _mla_qkv(xn, p, cfg, positions)

    if decode:
        write_rows(cache["ckv"], ckv, pos)
        write_rows(cache["krope"], krope, pos)
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
        s = (torch.einsum("bshr,btr->bhst", q_c, ckv_c)
             + torch.einsum("bshk,btk->bhst", q_rope, kr_c)
             ).float() * (hd + rhd) ** -0.5
        kv_pos = torch.arange(ckv_c.shape[1], device=x.device)
        s = torch.where(kv_pos[None, None, None, :] <= pos, s,
                        torch.full_like(s, -1e30))
        a = torch.softmax(s, dim=-1).to(x.dtype)
        ctxv = torch.einsum("bhst,btr->bshr", a, ckv_c)       # (B,S,H,r)
        v_ctx = torch.einsum("bshr,rhv->bshv", ctxv, p["w_uv"])
        out = torch.einsum("bshv,hvd->bsd", v_ctx, p["wo"])
        return x + out, cache

    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
    v = torch.einsum("bsr,rhv->bshv", ckv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rhd)],
                  dim=-1)
    o = flash_attention(q, k, v, True, None, 0, 1024, (hd + rhd) ** -0.5)
    out = torch.einsum("bshv,hvd->bsd", o.to(x.dtype), p["wo"])
    return x + out, {"ckv": ckv, "krope": krope}


def _apply_ffn(x, p, spec: LayerSpec, cfg: ModelConfig):
    """Returns (out, aux_loss)."""
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "mlp":
        return x + gated_mlp(xn, p["w_gate"], p["w_up"], p["w_down"]), zero
    moe_out, aux = moe_ffn(xn, p, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor)
    out = x + moe_out
    if cfg.n_shared_experts:
        out = out + gated_mlp(xn, p["sh_gate"], p["sh_up"], p["sh_down"])
    return out, aux


def _apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
                 pos=None):
    """One layer: (x, cache piece, aux). In decode the piece is ``cache``,
    updated in place; otherwise what prefill keeps (k / v, ckv / krope,
    or the Mamba state h / conv)."""
    piece = None
    if spec.mixer == "attn":
        x, piece = _apply_attn(x, p, spec, cfg, cache, pos)
    elif spec.mixer == "mla":
        x, piece = _apply_mla(x, p, spec, cfg, cache, pos)
    elif spec.mixer == "mamba":
        xn = rms_norm(x, p["norm1"], cfg.norm_eps)
        if cache is not None and pos is not None:
            out, (h, conv) = mamba_decode_step(
                xn, p, (cache["h"], cache["conv"]), d_state=cfg.ssm_state)
            cache["h"].copy_(h)
            cache["conv"].copy_(conv)
            piece = cache
        else:
            out, (h, conv) = mamba_mixer(xn, p, d_state=cfg.ssm_state,
                                         return_state=True)
            piece = {"h": h, "conv": conv}
        x = x + out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn != "none":
        x, aux = _apply_ffn(x, p, spec, cfg)
    return x, piece, aux


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def act_dtype(params):
    """The activations' dtype: the parameters' (bf16, ``DTYPE``, as in the
    reference; float32 for a float32 twin of a model)."""
    return params["embed"].dtype


def _embed(params, tokens):
    return params["embed"][tokens].to(act_dtype(params))


def _inputs(params, tokens, patches):
    x = _embed(params, tokens)
    if patches is not None:
        x = torch.cat([patches.to(x.dtype), x], dim=1)
    return x


def unstack_groups(groups):
    """Per group g, the list of its pattern positions' parameter dicts
    (``torch.unbind`` views of the stacked leaves: the backward stacks
    each leaf's gradient once, not a full-size buffer per group)."""
    per_pos = [{k: v.unbind(0) for k, v in gp.items()} for gp in groups]
    n = len(next(iter(per_pos[0].values()))) if per_pos[0] else 0
    return [[{k: v[g] for k, v in pos.items()} for pos in per_pos]
            for g in range(n)]


def forward_hidden(params, tokens, cfg: ModelConfig, patches=None):
    """Token (+ optional VLM patch) embedding -> (final hidden states,
    summed MoE aux loss). Each group (all the pattern's layers of one
    group) is recomputed in the backward."""
    x = _inputs(params, tokens, patches)

    def group_body(x, gps):
        aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp, spec in zip(gps, cfg.pattern):
            x, _, aux = _apply_layer(x, gp, spec, cfg)
            aux_t = aux_t + aux
        return x, aux_t

    aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
    for gps in unstack_groups(params["groups"]):
        x, aux = rematerialize(group_body, x, gps)
        aux_t = aux_t + aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_t


def train_loss(params, batch, cfg: ModelConfig, aux_weight: float = 0.01):
    """batch: {"tokens": (B, S+1) int, optional "patches": (B, Np, d)}.
    The mean next-token cross-entropy over the text positions (targets
    ``tokens[:, 1:]``, those < 0 masked out) plus ``aux_weight`` times the
    MoE load-balance loss; a float32 scalar."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    patches = batch.get("patches")
    x, aux = forward_hidden(params, inp, cfg, patches=patches)
    if patches is not None:
        x = x[:, patches.shape[1]:]   # loss on text positions only
    mask = (tgt >= 0).float()
    loss = chunked_cross_entropy(x, params["embed"], torch.clamp_min(tgt, 0),
                                 mask)
    return loss + aux_weight * aux


def logits_of(params, h):
    """Logits of hidden states: a bf16 product with the tied embedding,
    cast to float32."""
    return (h @ params["embed"].T).float()


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=DTYPE, *,
               device):
    """Decode cache on ``device``: per pattern position a dict of (G, ...)
    leaves; a windowed layer's ring holds ``min(window, S_max)`` rows."""
    caches = []
    G = cfg.n_groups

    def z(*shape, dt=dtype):
        return torch.zeros((G,) + shape, dtype=dt, device=device)

    for spec in cfg.pattern:
        if spec.mixer == "attn":
            S_c = min(spec.window, S_max) if spec.window else S_max
            caches.append({"k": z(B, S_c, cfg.n_kv_heads, cfg.head_dim),
                           "v": z(B, S_c, cfg.n_kv_heads, cfg.head_dim)})
        elif spec.mixer == "mla":
            caches.append({"ckv": z(B, S_max, cfg.kv_lora_rank),
                           "krope": z(B, S_max, cfg.rope_head_dim)})
        elif spec.mixer == "mamba":
            state = init_mamba_state(B, cfg.d_inner, cfg.ssm_state,
                                     cfg.d_conv, dtype, device)
            caches.append({k: torch.stack([t] * G)
                           for k, t in zip(("h", "conv"), state)})
        else:
            caches.append({})
    return caches


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    """token: (B, 1) int; pos: the position (an int or a 0-d tensor).
    Returns (logits (B, V) float32, cache), the cache updated in place."""
    pos = as_pos(pos, token.device)
    x = _embed(params, token)
    for g in range(cfg.n_groups):
        for li, spec in enumerate(cfg.pattern):
            gc = group_slice(cache[li], g) if cache[li] else None
            x, _, _ = _apply_layer(x, group_slice(params["groups"][li], g),
                                   spec, cfg, cache=gc, pos=pos)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_of(params, x[:, 0, :]), cache


def prefill(params, tokens, cfg: ModelConfig, S_cache: int, patches=None):
    """Forward pass that also returns the per-layer cache, in the
    reference's layout: a windowed layer keeps the *last* ``min(w, S)``
    positions at rows 0.., a full layer keeps S rows (``S_cache`` is
    unused), a Mamba layer its final state. Returns (last hidden, cache)."""
    del S_cache
    x = _inputs(params, tokens, patches)
    S = x.shape[1]
    per_group = [[] for _ in cfg.pattern]
    for g in range(cfg.n_groups):
        for li, spec in enumerate(cfg.pattern):
            x, piece, _ = _apply_layer(
                x, group_slice(params["groups"][li], g), spec, cfg)
            if spec.mixer == "attn" and spec.window:
                w = min(spec.window, S)
                piece = {"k": piece["k"][:, -w:], "v": piece["v"][:, -w:]}
            per_group[li].append(piece or {})
    cache = [{k: torch.stack([pg[k] for pg in pieces])
              for k in pieces[0]} for pieces in per_group]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, -1, :], cache
