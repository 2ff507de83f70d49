"""Generic decoder LM covering dense / GQA, MLA + MoE, Mamba, hybrid and VLM
architectures (the port of ``repro.models.lm``).

Parameter pytree, the reference's names and layout:
  { "embed": (V, d), "final_norm": (d,),
    "groups": [ per-pattern-position dict, every leaf stacked (G, ...) ] }

Entry points:
  train_loss(params, batch, cfg, ctx=None)    -> scalar loss
  forward_hidden(params, tokens, cfg)         -> (final hidden, aux loss)
  prefill(params, tokens, cfg, S_cache)       -> (last hidden, cache)
  decode_step(params, cache, token, pos, cfg) -> (logits, cache)

The schema carries the reference's partition specs as tuples
(``param_pspecs``); ``Ctx`` holds a rank layout (``launch.mesh.Layout``)
for data-parallel training, where each rank computes on its rows and the
MoE layers run expert-parallel. The reference scans over the groups; here
a Python loop indexes the stacked leaves. Its sharding constraints and
barriers place arrays on its mesh; here each rank holds its blocks, so
they are not carried over. Attention without a cache goes through
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

from repro_torch.launch.mesh import local_slice
from repro_torch.pytree import tree_leaves, tree_map

from .config import LayerSpec, ModelConfig
from .flash import flash_attention
from .layers import (attention, chunked_cross_entropy, gated_mlp,
                     rematerialize, rms_norm, rope)
from .mamba import init_mamba_state, mamba_decode_step, mamba_mixer
from .moe import moe_ffn

DTYPE = torch.bfloat16


# --------------------------------------------------------------------------
# parameter schema: name -> (shape, init scale, partition spec)
#
# A partition spec is the reference's ``PartitionSpec`` as a plain tuple:
# one entry per dimension, an axis name of the rank layout, a tuple of
# names, or None. Only the axes a ``launch.mesh.Layout`` gives more than
# one rank shard anything.
# --------------------------------------------------------------------------

def _attn_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cfg.attn_shard == "heads":
        return {
            "norm1": ((d,), 0.0, (None,)),
            "wq": ((d, H, hd), 0.02, (None, "model", None)),
            "wk": ((d, Hkv, hd), 0.02, (None, None, None)),
            "wv": ((d, Hkv, hd), 0.02, (None, None, None)),
            "wo": ((H, hd, d), 0.02, ("model", None, None)),
        }
    if cfg.attn_shard == "head_dim":
        return {
            "norm1": ((d,), 0.0, (None,)),
            "wq": ((d, H, hd), 0.02, (None, None, "model")),
            "wk": ((d, Hkv, hd), 0.02, (None, None, "model")),
            "wv": ((d, Hkv, hd), 0.02, (None, None, "model")),
            "wo": ((H, hd, d), 0.02, (None, "model", None)),
        }
    return {  # replicated
        "norm1": ((d,), 0.0, (None,)),
        "wq": ((d, H, hd), 0.02, (None, None, None)),
        "wk": ((d, Hkv, hd), 0.02, (None, None, None)),
        "wv": ((d, Hkv, hd), 0.02, (None, None, None)),
        "wo": ((H, hd, d), 0.02, (None, None, None)),
    }


def _mla_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, H = cfg.d_model, cfg.n_heads
    hd, rhd, dv = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    out = {
        "norm1": ((d,), 0.0, (None,)),
        "w_dkv": ((d, r), 0.02, (None, None)),
        "kv_norm": ((r,), 0.0, (None,)),
        "w_krope": ((d, rhd), 0.02, (None, None)),
        "w_uk": ((r, H, hd), 0.02, (None, "model", None)),
        "w_uv": ((r, H, dv), 0.02, (None, "model", None)),
        "wo": ((H, dv, d), 0.02, ("model", None, None)),
    }
    if cfg.q_lora_rank:
        out.update({
            "w_dq": ((d, cfg.q_lora_rank), 0.02, (None, None)),
            "q_norm": ((cfg.q_lora_rank,), 0.0, (None,)),
            "w_uq": ((cfg.q_lora_rank, H, hd), 0.02, (None, "model", None)),
            "w_uq_rope": ((cfg.q_lora_rank, H, rhd), 0.02,
                          (None, "model", None)),
        })
    else:
        out.update({
            "w_q": ((d, H, hd), 0.02, (None, "model", None)),
            "w_q_rope": ((d, H, rhd), 0.02, (None, "model", None)),
        })
    return out


def _mamba_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, di, ds = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr = max(d // 16, 1)
    return {
        "norm1": ((d,), 0.0, (None,)),
        "in_x": ((d, di), 0.02, (None, "model")),
        "in_z": ((d, di), 0.02, (None, "model")),
        "conv_w": ((cfg.d_conv, di), 0.02, (None, "model")),
        "conv_b": ((di,), 0.0, ("model",)),
        "w_B": ((di, ds), 0.02, ("model", None)),
        "w_C": ((di, ds), 0.02, ("model", None)),
        "dt_down": ((di, dtr), 0.02, ("model", None)),
        "dt_up": ((dtr, di), 0.02, (None, "model")),
        "dt_bias": ((di,), 0.0, ("model",)),
        "A_log": ((di, ds), 0.0, ("model", None)),
        "D": ((di,), 0.0, ("model",)),
        "out": ((di, d), 0.02, ("model", None)),
    }


def _mlp_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "norm2": ((d,), 0.0, (None,)),
        "w_gate": ((d, ff), 0.02, (None, "model")),
        "w_up": ((d, ff), 0.02, (None, "model")),
        "w_down": ((ff, d), 0.02, ("model", None)),
    }


def _moe_schema(cfg: ModelConfig) -> Dict[str, tuple]:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out = {
        "norm2": ((d,), 0.0, (None,)),
        "router": ((d, E), 0.02, (None, None)),
        "gate": ((E, d, ff), 0.02, ("data", None, "model")),
        "up": ((E, d, ff), 0.02, ("data", None, "model")),
        "down": ((E, ff, d), 0.02, ("data", "model", None)),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        out.update({
            "sh_gate": ((d, sff), 0.02, (None, "model")),
            "sh_up": ((d, sff), 0.02, (None, "model")),
            "sh_down": ((sff, d), 0.02, ("model", None)),
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


def stack_schema(sch: Dict[str, tuple], n: int) -> Dict[str, tuple]:
    """A layer schema stacked ``n`` deep: a leading (n, ...) axis, not
    sharded."""
    return {k: ((n,) + shp, sc, (None,) + tuple(ps))
            for k, (shp, sc, ps) in sch.items()}


def model_schema(cfg: ModelConfig):
    """Full-pytree schema {path: (shape, scale, pspec)}, mirroring the
    params."""
    return {
        "embed": ((cfg.vocab, cfg.d_model), 0.02, ("model", None)),
        "final_norm": ((cfg.d_model,), 0.0, (None,)),
        "groups": [stack_schema(layer_schema(cfg, spec), cfg.n_groups)
                   for spec in cfg.pattern],
    }


def map_schema(schema, fn):
    """Apply ``fn(shape, scale, pspec)`` to every leaf of a schema (dicts
    and lists of dicts, in insertion order)."""
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


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=DTYPE,
                layout=None):
    """Seeded parameters on ``generator.device``; the reference's
    ``fold_in`` draws have no torch twin, so the values are the port's
    own (``convert.lm_params_from_reference`` carries the reference's).
    Under a ``launch.mesh.Layout`` each leaf is drawn whole and this rank
    keeps its block (``launch.mesh.local_slice``), so every rank draws the
    same values and a sharded model is the slices of the unsharded one."""
    return init_from_schema(model_schema(cfg), generator, dtype, layout)


def init_from_schema(schema, generator, dtype, layout=None):
    """Every leaf of ``schema`` drawn (``draw_leaf``), then cut to this
    rank's block under ``layout``."""
    return map_schema(schema, lambda shp, sc, ps: local_slice(
        draw_leaf(shp, sc, generator, dtype), ps, layout))


def param_pspecs(cfg: ModelConfig):
    """The partition spec of every parameter leaf, as tuples (the
    reference's ``param_pspecs``)."""
    return map_schema(model_schema(cfg), lambda shp, sc, ps: tuple(ps))


# --------------------------------------------------------------------------
# the rank context
# --------------------------------------------------------------------------

class Ctx:
    """The rank layout threaded through the forward pass (the reference's
    mesh ``Ctx``; ``Ctx()`` is no layout, one device).

    ``dp`` are the data-parallel axes, ("pod", "data") when the layout has
    a pod axis. Under a layout the model computes on this rank's rows of
    the global batch (``rows``): rank position k of n along ``dp`` takes
    rows [k B / n, (k + 1) B / n), the block the reference's
    ``ctx.cst(x, ctx.dp, ...)`` places on that device.
    """

    def __init__(self, layout=None):
        self.layout = layout
        if layout is not None and "pod" in layout.axes:
            self.dp = ("pod", "data")
        else:
            self.dp = ("data",)

    @property
    def n_dp(self) -> int:
        """Ranks along the data-parallel axes (1 without a layout)."""
        if self.layout is None:
            return 1
        return self.layout.size(tuple(a for a in self.dp
                                      if a in self.layout.axes))

    def dp_divides(self, n: int) -> bool:
        """n splits evenly over the data-parallel ranks (False without a
        layout, as the reference's without a mesh)."""
        return self.layout is not None and n % self.n_dp == 0

    def rows(self, batch):
        """This rank's rows (axis 0) of every leaf of a global batch."""
        if self.layout is None or self.n_dp == 1:
            return batch
        dp = tuple(a for a in self.dp if a in self.layout.axes)
        k = self.layout.index(dp)

        def cut(t):
            if not self.dp_divides(t.shape[0]):
                raise ValueError(f"batch of {t.shape[0]} rows does not "
                                 f"split over {self.n_dp} data ranks")
            step = t.shape[0] // self.n_dp
            return t[k * step:(k + 1) * step]

        return tree_map(cut, batch)


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


def _apply_ffn(x, p, spec: LayerSpec, cfg: ModelConfig, ctx=None):
    """Returns (out, aux_loss). Under a layout the MoE runs expert-parallel
    over the "data" axis (x holds this rank's rows of a batch split over
    the data ranks, so the reference's ``dp_divides`` of the global token
    count holds); its aux loss is this rank's, which the step's mean over
    the data ranks turns into the reference's mean of the shards' aux."""
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "mlp":
        return x + gated_mlp(xn, p["w_gate"], p["w_up"], p["w_down"]), zero
    B, S, _ = x.shape
    use_ep = ctx is not None and ctx.dp_divides(B * S * ctx.n_dp)
    moe_out, aux = moe_ffn(xn, p, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           layout=ctx.layout if use_ep else None,
                           ep_axis="data" if use_ep else None)
    out = x + moe_out
    if cfg.n_shared_experts:
        out = out + gated_mlp(xn, p["sh_gate"], p["sh_up"], p["sh_down"])
    return out, aux


def _apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
                 pos=None, ctx=None):
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
        x, aux = _apply_ffn(x, p, spec, cfg, ctx)
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


def forward_hidden(params, tokens, cfg: ModelConfig, patches=None,
                   ctx=None):
    """Token (+ optional VLM patch) embedding -> (final hidden states,
    summed MoE aux loss). Each group (all the pattern's layers of one
    group) is recomputed in the backward. Under ``ctx``'s layout the
    tokens are this rank's rows and the MoE layers run expert-parallel."""
    x = _inputs(params, tokens, patches)

    def group_body(x, gps):
        aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp, spec in zip(gps, cfg.pattern):
            x, _, aux = _apply_layer(x, gp, spec, cfg, ctx=ctx)
            aux_t = aux_t + aux
        return x, aux_t

    aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
    for gps in unstack_groups(params["groups"]):
        x, aux = rematerialize(group_body, x, gps)
        aux_t = aux_t + aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_t


def train_loss(params, batch, cfg: ModelConfig, ctx=None,
               aux_weight: float = 0.01):
    """batch: {"tokens": (B, S+1) int, optional "patches": (B, Np, d)}.
    The mean next-token cross-entropy over the text positions (targets
    ``tokens[:, 1:]``, those < 0 masked out) plus ``aux_weight`` times the
    MoE load-balance loss; a float32 scalar. Under ``ctx``'s layout the
    batch is this rank's rows (``Ctx.rows``) and the loss this rank's;
    the data-parallel step averages it over the data ranks."""
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    patches = batch.get("patches")
    x, aux = forward_hidden(params, inp, cfg, patches=patches, ctx=ctx)
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
