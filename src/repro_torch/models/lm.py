"""Generic decoder LM covering dense / GQA, MLA + MoE, Mamba, hybrid and VLM
architectures (the port of ``repro.models.lm``).

Parameter pytree, the reference's names and layout:
  { "embed": (V, d), "final_norm": (d,),
    "groups": [ per-pattern-position dict, every leaf stacked (G, ...) ] }
A ``PublishedConfig`` may add "unembed": (V, d), an untied head
(``tie_embeddings`` False), and "lead": one dict of the leading dense
layers' leaves stacked (n_dense_lead, ...), run before the groups; its
decode cache then starts with the leading layers' entry (stacked the
same way), before the pattern positions'. Those fields, and dropless
routing, run on one device: under a layout they raise (``one_device``).

Entry points (``ctx`` an ``lm.Ctx``, None for one device):
  train_loss(params, batch, cfg, ctx=None)         -> scalar loss
  forward_hidden(params, tokens, cfg, ctx=None)    -> (final hidden, aux)
  prefill(params, tokens, cfg, S_cache, ctx=None)  -> (last hidden, cache)
  decode_step(params, cache, token, pos, cfg, ctx=None) -> (logits, cache)

The schema carries the reference's partition specs as tuples
(``param_pspecs``); ``Ctx`` holds a rank layout (``launch.mesh.Layout``).
Over the data axes each rank computes on its rows and the MoE layers run
expert-parallel. Over the model axis (tensor parallelism, Megatron's
scheme) each rank holds its block of every leaf the schema splits over
"model" and computes on it: column-split products in, row-split products
out, each closed by one sum over the model ranks (``Ctx.reduce``), and a
replicated activation entering a split region through ``Ctx.copy``, so
every replicated leaf's gradient comes out whole and equal on every model
rank; the vocabulary is split for the embedding and the cross-entropy.
The reference gets the same from GSPMD; here the collectives are
explicit. Decode caches split their sequence over "model"
(``launch.shapes.cache_pspecs``, flash-decode). The reference scans
over the groups; here a Python loop indexes the stacked leaves. Its sharding constraints and
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

from repro_torch import trace
from repro_torch.launch.mesh import (all_gather_dim, all_reduce_, copy_to,
                                     gather_from, local_shape, local_slice,
                                     reduce_from, sharded_dims)
from repro_torch.pytree import tree_leaves, tree_map

from .config import LayerSpec, ModelConfig
from .flash import flash_attention
from .layers import (FLAGS, acc_dtype, attention, chunk_bias,
                     chunked_cross_entropy, gated_mlp, kv_chunk_len,
                     online_softmax, rematerialize, rms_norm, rope, scale_in,
                     yarn_freqs, yarn_mscale)
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
    out = {"embed": ((cfg.vocab, cfg.d_model), 0.02, ("model", None))}
    if not cfg.tie_embeddings:
        out["unembed"] = ((cfg.vocab, cfg.d_model), 0.02, ("model", None))
    out["final_norm"] = ((cfg.d_model,), 0.0, (None,))
    if cfg.n_dense_lead:
        out["lead"] = stack_schema(layer_schema(cfg, cfg.lead_spec),
                                   cfg.n_dense_lead)
    out["groups"] = [stack_schema(layer_schema(cfg, spec), cfg.n_groups)
                     for spec in cfg.pattern]
    return out


def one_device(cfg: ModelConfig, layout) -> None:
    """Raise where ``cfg`` uses a field the layouts do not support yet
    (leading dense layers, an untied head, dropless routing) and a
    layout is given."""
    if layout is None:
        return
    for field, on in (("n_dense_lead", cfg.n_dense_lead),
                      ("tie_embeddings", not cfg.tie_embeddings),
                      ("moe_dropless", cfg.moe_dropless)):
        if on:
            raise NotImplementedError(
                f"{cfg.name}: {field}={getattr(cfg, field)!r} runs on one "
                f"device; no layout takes it yet")


def map_schema(schema, fn):
    """Apply ``fn(shape, scale, pspec)`` to every leaf of a schema (dicts
    and lists of dicts, in insertion order)."""
    out = {}
    for k, v in schema.items():
        if isinstance(v, list):
            out[k] = [{kk: fn(*vv) for kk, vv in g.items()} for g in v]
        elif isinstance(v, dict):
            out[k] = {kk: fn(*vv) for kk, vv in v.items()}
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
    one_device(cfg, layout)
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


def abstract_params(cfg: ModelConfig, dtype=DTYPE, layout=None):
    """Every parameter leaf as an empty tensor of this rank's block shape
    under ``layout`` (the whole leaf without one), on the current device:
    fake tensors under ``FakeTensorMode`` (the dry run), real ones
    otherwise. Nothing is drawn (the reference's ``abstract_params``)."""
    one_device(cfg, layout)
    return abstract_from_schema(model_schema(cfg), dtype, layout)


def abstract_from_schema(schema, dtype, layout=None):
    return map_schema(schema, lambda shp, sc, ps: torch.empty(
        local_shape(shp, ps, layout), dtype=dtype))


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

    The model axis: ``tp`` ranks (1 without a layout or where the layout
    gives "model" one rank), this rank's position ``tp_rank`` and their
    group ``tp_group``. Each leaf the schema splits over "model" holds
    this rank's block, and ``copy`` / ``reduce`` / ``gather`` are the
    region boundaries (``launch.mesh.copy_to`` / ``reduce_from`` /
    ``gather_from``); at one rank they are the identity and nothing is
    issued.
    """

    def __init__(self, layout=None):
        self.layout = layout
        if layout is not None and "pod" in layout.axes:
            self.dp = ("pod", "data")
        else:
            self.dp = ("data",)
        split = (layout is not None and "model" in layout.axes
                 and layout.size("model") > 1)
        self.tp = layout.size("model") if split else 1
        self.tp_rank = layout.index("model") if split else 0
        self.tp_group = layout.group("model") if split else None
        if split and self.tp_group is None:
            raise RuntimeError(f"{layout}: no group for its {self.tp} "
                               f"model ranks")

    def copy(self, x):
        return copy_to(x, self.tp_group)

    def reduce(self, x):
        return reduce_from(x, self.tp_group)

    def gather(self, x, dim: int):
        return gather_from(x, self.tp_group, dim)

    def block(self, n: int, what: str) -> tuple:
        """(start, length) of this rank's block of ``n`` entries split over
        the model ranks."""
        if n % self.tp:
            raise ValueError(f"{what} ({n}) does not split over "
                             f"{self.tp} model ranks")
        step = n // self.tp
        return self.tp_rank * step, step

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

    def dp_group(self):
        """The group of the data-parallel axes (None at one rank)."""
        if self.layout is None or self.n_dp == 1:
            return None
        return self.layout.group(tuple(a for a in self.dp
                                       if a in self.layout.axes))

    def split_of(self, spec, dim: int):
        """(group, ranks, this rank's index) of the ranks a cache leaf's
        dimension ``dim`` is split over by ``spec``; (None, 1, 0) where it
        is whole."""
        for d, names in sharded_dims(spec, self.layout):
            if d == dim:
                return (self.layout.group(names), self.layout.size(names),
                        self.layout.index(names))
        return None, 1, 0


NO_CTX = Ctx()


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


# A decode cache split over ranks along its sequence (``launch.shapes.
# cache_pspecs``): ``split`` is (group, n, k), rank k of n holding rows
# [k S_c / n, (k + 1) S_c / n) of the S_c rows.

def write_block_row(buf: torch.Tensor, row: torch.Tensor,
                    start: torch.Tensor, k: int):
    """Write the one sequence row ``row`` (B, 1, ...) at global row
    ``start`` into rank k's block ``buf`` of the cache, in place, where
    the row falls in the block; elsewhere the block is left as it is."""
    S_loc = buf.shape[1]
    local = start - k * S_loc
    owns = (local >= 0) & (local < S_loc)
    idx = local.clamp(0, S_loc - 1).reshape(1)
    old = buf.index_select(1, idx)
    buf.index_copy_(1, idx, torch.where(owns, row.to(buf.dtype), old))


def block_valid_rows(pos: torch.Tensor, S_c: int, k: int, S_loc: int,
                     B: int) -> torch.Tensor:
    """(B,) rows of rank k's block valid once ``pos`` is written: its
    share of ``min(pos + 1, S_c)``."""
    return torch.clamp(torch.clamp(pos + 1, max=S_c) - k * S_loc, 0,
                       S_loc).expand(B)


def merged_decode_attention(q, k, v, kv_len, group, scale=None):
    """Flash-decode over a sequence split across ``group``: each rank's
    online softmax over its block (``kv_len`` its valid rows), then the
    ranks' partial results merged by log-sum-exp. q: (B, Sq, Hq, hd), all
    heads; k / v: this rank's (B, S_loc, Hkv, hd / dv). Returns (B, Sq,
    Hq, dv) in q's dtype. A block with no valid row adds nothing (its max
    is NEG_INF, so its weight exp(max - global max) is 0)."""
    B, Sq, Hq, hd = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    sc = scale if scale is not None else hd ** -0.5
    qh = scale_in(q, sc).reshape(B, Sq, Hkv, Hq // Hkv, hd)
    ck = kv_chunk_len(k.shape[1], 1024)
    m, l, acc = online_softmax(
        qh, k, v, ck, lambda ci: chunk_bias(Sq, ck, ci, 0, False, None,
                                            kv_len, q.device))
    top = all_reduce_(m.clone(), group, "max")
    w = torch.exp(m - top)
    l = all_reduce_(l * w, group)
    acc = all_reduce_(acc * w[..., None], group)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, Hq, dv).to(q.dtype)


def _kv_for_heads(t, h0: int, n: int, G: int):
    """The K / V heads of query heads [h0, h0 + n) of t (B, S, Hkv, hd)
    under GQA (query head j reads KV head j // G): the KV heads alone
    where the block aligns with the groups, else repeated to one per
    query head (the reference's Megatron GQA repeat)."""
    lo, hi = h0 // G, -(-(h0 + n) // G)
    sel = t[:, :, lo:hi]
    if h0 % G == 0 and n % G == 0:
        return sel
    start = h0 - lo * G
    return sel.repeat_interleave(G, dim=2)[:, :, start:start + n]


def _split_hd_attention(q, k, v, ctx: Ctx, causal: bool, window, scale):
    """Attention with head_dim split over the model ranks (``attn_shard=
    "head_dim"``): each rank's partial scores over its block of hd are
    summed over the ranks before the softmax, and the probabilities
    enter the split product with v through ``ctx.copy``. Plain (not
    chunked) attention; returns this rank's block of the output's
    head_dim."""
    B, S, Hq, hl = q.shape
    Hkv = k.shape[2]
    f = acc_dtype(q)
    qh = scale_in(q, scale).reshape(B, S, Hkv, Hq // Hkv, hl).to(f)
    s = ctx.reduce(torch.einsum("bqhgd,bkhd->bqhgk", qh, k.to(f)))
    s = s + chunk_bias(S, k.shape[1], 0, 0, causal, window, None, q.device)
    p = ctx.copy(torch.softmax(s, dim=-1))
    o = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).to(f), v.to(f))
    return o.reshape(B, S, Hq, v.shape[-1]).to(q.dtype)


def attend(q, k, v, causal: bool, window=None, scale=None):
    """Attention without a cache: ``flash.flash_attention`` (its
    backward recomputes the probabilities), or ``layers.attention`` with
    ``FLAGS["flash"]`` off."""
    if FLAGS["flash"]:
        return flash_attention(q, k, v, causal, window, 0, 1024, scale)
    return attention(q, k, v, causal=causal, window=window, scale=scale)


def _tp_mode(cfg: ModelConfig, ctx: Ctx) -> str:
    """How attention splits over the model ranks: the config's
    ``attn_shard``, or "replicated" at one rank."""
    return cfg.attn_shard if ctx.tp > 1 else "replicated"


def _apply_attn(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
                pos=None, ctx: Ctx = NO_CTX, cspec=None):
    """Returns (out, cache piece). Decode (cache and pos given) writes k, v
    into the cache at ``pos`` (at ``pos % S_c`` for a windowed layer's
    ring) and attends to the valid rows; otherwise the piece is the
    sequence's roped k and v (this rank's block of head_dim under
    ``attn_shard="head_dim"``, else every KV head).

    Over the model ranks: "heads" computes this rank's query heads and
    every KV head (``wk`` / ``wv`` replicated), which enter the split
    region through ``ctx.copy`` and are cut to the rank's heads; "head_dim"
    splits q, k and v over hd and sums the scores over the ranks;
    "replicated" computes attention whole. ``wo``'s row-split product is
    cast to the activations' dtype and then summed over the ranks. In
    decode the cache is split over its sequence by ``cspec``
    (``launch.shapes.cache_pspecs``): q and the new row are gathered to
    every head, the row is written by the rank whose block holds it, and
    the ranks' attention is merged (``merged_decode_attention``)."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    mode = _tp_mode(cfg, ctx)
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    xq = ctx.copy(xn) if mode != "replicated" else xn
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"])
    kv_in = xq if mode == "head_dim" else xn
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"])

    decode = cache is not None and pos is not None
    positions = (positions_at(pos, S) if decode
                 else torch.arange(S, device=x.device))
    rope_kw = {}
    if mode == "head_dim":
        h0, hl = ctx.block(hd, "head_dim")
        rope_kw = dict(pair_offset=h0 // 2, half_total=hd // 2)
    q = rope(q, positions, spec.rope_theta, **rope_kw)
    k = rope(k, positions, spec.rope_theta, **rope_kw)

    if decode:
        group, n, r = ctx.split_of(cspec, 2)
        if mode == "heads":
            q = ctx.gather(q, 2)
        elif mode == "head_dim":
            q, k, v = (ctx.gather(t, 3) for t in (q, k, v))
        S_loc = cache["k"].shape[1]
        S_c = S_loc * n
        write = pos % S_c if spec.window is not None else pos
        if group is None:
            write_rows(cache["k"], k, write)
            write_rows(cache["v"], v, write)
            o = attention(q, cache["k"], cache["v"], causal=False,
                          kv_len=valid_rows(pos, S_c, B), q_offset=pos,
                          window=None)
        else:
            write_block_row(cache["k"], k, write, r)
            write_block_row(cache["v"], v, write, r)
            o = merged_decode_attention(
                q, cache["k"], cache["v"],
                block_valid_rows(pos, S_c, r, S_loc, B), group)
        if mode == "heads":
            h0, hl = ctx.block(H, "n_heads")
            o = o[:, :, h0:h0 + hl]
        elif mode == "head_dim":
            o = o[..., h0:h0 + hl]
        piece = cache
    elif mode == "heads":
        h0, hl = ctx.block(H, "n_heads")
        G = H // Hkv
        o = attend(q, _kv_for_heads(ctx.copy(k), h0, hl, G),
                   _kv_for_heads(ctx.copy(v), h0, hl, G), True, spec.window)
        piece = {"k": k, "v": v}
    elif mode == "head_dim":
        o = _split_hd_attention(q, k, v, ctx, True, spec.window, hd ** -0.5)
        piece = {"k": k, "v": v}
    else:
        o = attend(q, k, v, True, spec.window)
        piece = {"k": k, "v": v}
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    if mode != "replicated":
        # the bf16 partials are summed, never a float32 accumulator
        out = ctx.reduce(out.to(x.dtype))
    return x + out, piece


def mla_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale: (nope + rope head dim) ** -0.5, times
    ``yarn_mscale(factor, mscale_all_dim) ** 2`` under YaRN."""
    sc = (cfg.head_dim + cfg.rope_head_dim) ** -0.5
    y = cfg.rope_yarn
    if y is not None and y.mscale_all_dim:
        sc = sc * yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return sc


def _mla_rope(t, positions, cfg: ModelConfig):
    """RoPE of MLA's rope part at base 10,000, under YaRN at its
    frequencies (``layers.yarn_freqs``)."""
    y = cfg.rope_yarn
    freqs = None if y is None else yarn_freqs(y, t.shape[-1], 10_000.0,
                                              t.device)
    return rope(t, positions, 10_000.0, freqs=freqs)


def _mla_qkv(xn, p, cfg: ModelConfig, positions, ctx: Ctx = NO_CTX):
    """(q_nope, q_rope, ckv, krope): the queries of this rank's heads (the
    replicated low-rank or normed input enters them through
    ``ctx.copy``), the compressed KV and the roped key part whole."""
    if cfg.q_lora_rank:
        cq = ctx.copy(rms_norm(xn @ p["w_dq"], p["q_norm"], cfg.norm_eps))
        q_nope = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
        q_rope = torch.einsum("bsr,rhk->bshk", cq, p["w_uq_rope"])
    else:
        xq = ctx.copy(xn)
        q_nope = torch.einsum("bsd,dhk->bshk", xq, p["w_q"])
        q_rope = torch.einsum("bsd,dhk->bshk", xq, p["w_q_rope"])
    q_rope = _mla_rope(q_rope, positions, cfg)
    ckv = rms_norm(xn @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)
    krope = _mla_rope((xn @ p["w_krope"])[:, :, None, :], positions, cfg)
    return q_nope, q_rope, ckv, krope[:, :, 0, :]


def _mla_decode(x, p, cfg, q_nope, q_rope, ckv, krope, cache, pos, ctx,
                cspec):
    """Absorbed MLA decode (W_uk folded into q) against the compressed
    cache; with the cache's sequence split over ranks the queries are
    gathered to every head, each rank scores its block, and the softmax
    and its product with ckv are merged over the ranks before the rank's
    heads go through ``w_uv`` and ``wo``."""
    H = cfg.n_heads
    group, n, r = ctx.split_of(cspec, 2)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
    if group is None:
        write_rows(cache["ckv"], ckv, pos)
        write_rows(cache["krope"], krope, pos)
    else:
        write_block_row(cache["ckv"], ckv, pos, r)
        write_block_row(cache["krope"], krope, pos, r)
    q_c, q_rope = ctx.gather(q_c, 2), ctx.gather(q_rope, 2)
    ckv_c, kr_c = cache["ckv"], cache["krope"]
    s = (torch.einsum("bshr,btr->bhst", q_c, ckv_c)
         + torch.einsum("bshk,btk->bhst", q_rope, kr_c)
         ).float() * mla_scale(cfg)
    kv_pos = r * ckv_c.shape[1] + torch.arange(ckv_c.shape[1],
                                               device=x.device)
    if trace.ON:
        trace.count("mla.cache_rows", torch.clamp(
            pos + 1, max=ckv_c.shape[1] * n) * ckv_c.shape[0])
    s = torch.where(kv_pos[None, None, None, :] <= pos, s,
                    torch.full_like(s, -1e30))
    if group is None:
        a = torch.softmax(s, dim=-1).to(x.dtype)
        ctxv = torch.einsum("bhst,btr->bshr", a, ckv_c)        # (B,S,H,r)
    else:
        top = all_reduce_(s.amax(dim=-1, keepdim=True), group, "max")
        e = torch.exp(s - top)
        a = (e / all_reduce_(e.sum(dim=-1, keepdim=True), group)
             ).to(x.dtype)
        ctxv = all_reduce_(torch.einsum("bhst,btr->bshr", a.float(),
                                        ckv_c.float()), group).to(x.dtype)
    if ctx.tp > 1:
        h0, hl = ctx.block(H, "n_heads")
        ctxv = ctxv[:, :, h0:h0 + hl]
    v_ctx = torch.einsum("bshr,rhv->bshv", ctxv, p["w_uv"])
    return ctx.reduce(torch.einsum("bshv,hvd->bsd", v_ctx, p["wo"]))


def _apply_mla(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
               pos=None, ctx: Ctx = NO_CTX, cspec=None):
    """Returns (out, cache piece): decode scores against the compressed
    cache (W_uk absorbed into q); otherwise full attention, the piece the
    sequence's ckv and roped k. Over the model ranks each rank computes
    its heads (``w_uq`` / ``w_q``, ``w_uk``, ``w_uv`` split over heads;
    the down-projections and norms replicated, their outputs entering
    through ``ctx.copy``) and ``wo``'s row-split product is summed."""
    with trace.span("mla"):
        return _mla(x, p, cfg, cache, pos, ctx, cspec)


def _mla(x, p, cfg: ModelConfig, cache, pos, ctx: Ctx, cspec):
    B, S, d = x.shape
    rhd = cfg.rope_head_dim
    xn = rms_norm(x, p["norm1"], cfg.norm_eps)
    decode = cache is not None and pos is not None
    positions = (positions_at(pos, S) if decode
                 else torch.arange(S, device=x.device))
    q_nope, q_rope, ckv, krope = _mla_qkv(xn, p, cfg, positions, ctx)

    if decode:
        return x + _mla_decode(x, p, cfg, q_nope, q_rope, ckv, krope, cache,
                               pos, ctx, cspec), cache

    ckv_in, krope_in = ctx.copy(ckv), ctx.copy(krope)
    k_nope = torch.einsum("bsr,rhk->bshk", ckv_in, p["w_uk"])
    v = torch.einsum("bsr,rhv->bshv", ckv_in, p["w_uv"])
    Hl = k_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, krope_in[:, :, None, :].expand(B, S, Hl, rhd)],
                  dim=-1)
    o = attend(q, k, v, True, None, mla_scale(cfg))
    out = torch.einsum("bshv,hvd->bsd", o.to(x.dtype), p["wo"])
    return x + ctx.reduce(out), {"ckv": ckv, "krope": krope}


def _apply_ffn(x, p, spec: LayerSpec, cfg: ModelConfig, ctx: Ctx = NO_CTX):
    """Returns (out, aux_loss). Under a layout the MoE runs expert-parallel
    over the "data" axis (x holds this rank's rows of a batch split over
    the data ranks, so the reference's ``dp_divides`` of the global token
    count holds); its aux loss is this rank's, which the step's mean over
    the data ranks turns into the reference's mean of the shards' aux.
    Over the model ranks the MLP (and the shared experts) are
    column-split in and row-split out, the experts' ff dimension is
    split, and each output is summed over the ranks."""
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn == "mlp":
        with trace.span("mlp"):
            return x + ctx.reduce(gated_mlp(ctx.copy(xn), p["w_gate"],
                                            p["w_up"], p["w_down"])), zero
    B, S, _ = x.shape
    use_ep = ctx.layout is not None and ctx.dp_divides(B * S * ctx.n_dp)
    moe_out, aux = moe_ffn(xn, p, n_experts=cfg.n_experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           layout=ctx.layout if use_ep else None,
                           ep_axis="data" if use_ep else None,
                           tp_group=ctx.tp_group,
                           dropless=cfg.moe_dropless, renorm=cfg.moe_renorm)
    out = x + moe_out
    if cfg.n_shared_experts:
        with trace.span("moe.shared"):
            out = out + ctx.reduce(gated_mlp(ctx.copy(xn), p["sh_gate"],
                                             p["sh_up"], p["sh_down"]))
    return out, aux


def _mamba_state_in(cache, ctx: Ctx, cspec):
    """(h, conv) of a Mamba decode cache for the step over the model
    ranks: the cache's blocks where its d_inner is split as the weights'
    is; where it is split wider (batch 1, d_inner over ("data", "model"),
    the reference's long-context placement) the whole state is gathered
    over the state's ranks and this rank's model block taken."""
    group, n, _ = ctx.split_of(cspec, 2)
    h, conv = cache["h"], cache["conv"]
    if n == ctx.tp:
        return h, conv
    h, conv = all_gather_dim(h, group, 1), all_gather_dim(conv, group, 2)
    h0, hl = ctx.block(h.shape[1], "d_inner")
    return h[:, h0:h0 + hl], conv[:, :, h0:h0 + hl]


def _mamba_state_out(h, conv, ctx: Ctx, cspec):
    """The new state's blocks for the cache (``_mamba_state_in``'s
    inverse): where the cache splits d_inner wider than the weights, the
    model ranks' blocks gathered whole and this rank's block of the
    cache's split cut."""
    _, n, r = ctx.split_of(cspec, 2)
    if n == ctx.tp:
        return h, conv
    h = all_gather_dim(h.contiguous(), ctx.tp_group, 1)
    conv = all_gather_dim(conv.contiguous(), ctx.tp_group, 2)
    step = h.shape[1] // n
    return h[:, r * step:(r + 1) * step], conv[:, :, r * step:(r + 1) * step]


def _apply_layer(x, p, spec: LayerSpec, cfg: ModelConfig, cache=None,
                 pos=None, ctx=None, cspec=None):
    """One layer: (x, cache piece, aux). In decode the piece is ``cache``,
    updated in place; otherwise what prefill keeps (k / v, ckv / krope,
    or the Mamba state h / conv). ``cspec`` is the decode cache's
    partition spec (``launch.shapes.cache_pspecs``) under a layout."""
    ctx = NO_CTX if ctx is None else ctx
    piece = None
    if spec.mixer == "attn":
        x, piece = _apply_attn(x, p, spec, cfg, cache, pos, ctx, cspec)
    elif spec.mixer == "mla":
        x, piece = _apply_mla(x, p, spec, cfg, cache, pos, ctx, cspec)
    elif spec.mixer == "mamba":
        xn = rms_norm(x, p["norm1"], cfg.norm_eps)
        if cache is not None and pos is not None:
            out, (h, conv) = mamba_decode_step(
                xn, p, _mamba_state_in(cache, ctx, cspec),
                d_state=cfg.ssm_state, tp_group=ctx.tp_group)
            h, conv = _mamba_state_out(h, conv, ctx, cspec)
            cache["h"].copy_(h)
            cache["conv"].copy_(conv)
            piece = cache
        else:
            out, (h, conv) = mamba_mixer(xn, p, d_state=cfg.ssm_state,
                                         return_state=True,
                                         tp_group=ctx.tp_group)
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


def embed_tokens(emb, tokens, dtype, ctx: Ctx = NO_CTX):
    """Rows ``tokens`` of the embedding, in ``dtype``. Over the model ranks
    ``emb`` is this rank's block of the vocabulary: each rank looks up
    the tokens its block holds (zeros elsewhere) and the rows are summed
    over the ranks."""
    if ctx.tp == 1:
        return emb[tokens].to(dtype)
    local = tokens - ctx.tp_rank * emb.shape[0]
    inside = ((local >= 0) & (local < emb.shape[0]))[..., None]
    rows = emb[local.clamp(0, emb.shape[0] - 1)].to(dtype)
    return ctx.reduce(torch.where(inside, rows, torch.zeros_like(rows)))


def _inputs(params, tokens, patches, ctx: Ctx = NO_CTX):
    x = embed_tokens(params["embed"], tokens, act_dtype(params), ctx)
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
    group) is recomputed in the backward, its collectives reissued in
    the same order on every rank. Under ``ctx``'s layout the tokens are
    this rank's rows, the MoE layers run expert-parallel and every leaf
    split over "model" is this rank's block; the hidden states are
    whole on every model rank. Under ``FLAGS["remat_policy"] ==
    "save_tp"`` the recompute reuses the group's all-reduced outputs."""
    ctx = NO_CTX if ctx is None else ctx
    one_device(cfg, ctx.layout)
    x = _inputs(params, tokens, patches, ctx)
    for g in range(cfg.n_dense_lead):
        x = rematerialize(lambda x, p: _apply_layer(x, p, cfg.lead_spec,
                                                    cfg)[0],
                          x, group_slice(params["lead"], g))

    def group_body(x, gps):
        aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
        for gp, spec in zip(gps, cfg.pattern):
            x, _, aux = _apply_layer(x, gp, spec, cfg, ctx=ctx)
            aux_t = aux_t + aux
        return x, aux_t

    aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
    for gps in unstack_groups(params["groups"]):
        x, aux = rematerialize(group_body, x, gps,
                               save_tp=FLAGS["remat_policy"] == "save_tp")
        aux_t = aux_t + aux
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_t


def train_loss(params, batch, cfg: ModelConfig, ctx=None,
               aux_weight: float = 0.01):
    """batch: {"tokens": (B, S+1) int, optional "patches": (B, Np, d)}.
    The mean next-token cross-entropy over the text positions (targets
    ``tokens[:, 1:]``, those < 0 masked out) plus ``aux_weight`` times the
    MoE load-balance loss; a float32 scalar. Under ``ctx``'s layout the
    batch is this rank's rows (``Ctx.rows``) and the loss this rank's;
    the data-parallel step averages it over the data ranks. Over the
    model ranks the loss is the same on each (the vocabulary-split
    cross-entropy)."""
    ctx = NO_CTX if ctx is None else ctx
    tokens = batch["tokens"]
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    patches = batch.get("patches")
    x, aux = forward_hidden(params, inp, cfg, patches=patches, ctx=ctx)
    if patches is not None:
        x = x[:, patches.shape[1]:]   # loss on text positions only
    mask = (tgt >= 0).float()
    loss = chunked_cross_entropy(x, head_weight(params),
                                 torch.clamp_min(tgt, 0), mask, ctx=ctx)
    return loss + aux_weight * aux


def head_weight(params):
    """The output head's (V, d) weight: "unembed" where the model has an
    untied head, else the tied embedding."""
    return params.get("unembed", params["embed"])


def logits_of(params, h, ctx=None):
    """Logits of hidden states: a bf16 product with the head's weight
    (``head_weight``), cast to float32; over the model ranks each rank's
    vocabulary block gathered whole."""
    with trace.span("lm.head"):
        out = (h @ head_weight(params).T).float()
    if ctx is None or ctx.tp == 1:
        return out
    return ctx.gather(out, out.dim() - 1)


def _cache_specs(cfg, B, ctx):
    """The decode cache's specs at global batch B under ``ctx``'s layout
    (None without one)."""
    if ctx.layout is None:
        return None
    from repro_torch.launch.shapes import cache_pspecs
    return cache_pspecs(cfg, B, ctx.layout)


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype=DTYPE, *,
               device, layout=None):
    """Decode cache on ``device``: per pattern position a dict of (G, ...)
    leaves; a windowed layer's ring holds ``min(window, S_max)`` rows.
    Under ``layout`` this rank's block of each leaf, as
    ``launch.shapes.cache_pspecs`` places it. Leading dense layers put
    their entry first, stacked (n_dense_lead, ...)."""
    one_device(cfg, layout)
    caches = []
    specs = _cache_specs(cfg, B, Ctx(layout))
    stacks = [(cfg.lead_spec, cfg.n_dense_lead)] if cfg.n_dense_lead else []
    stacks += [(spec, cfg.n_groups) for spec in cfg.pattern]

    def z(li, name, *shape, dt=dtype):
        shape = (G,) + shape
        if specs is not None:
            shape = local_shape(shape, specs[li][name], layout)
        return torch.zeros(shape, dtype=dt, device=device)

    for li, (spec, G) in enumerate(stacks):
        if spec.mixer == "attn":
            S_c = min(spec.window, S_max) if spec.window else S_max
            caches.append({n: z(li, n, B, S_c, cfg.n_kv_heads, cfg.head_dim)
                           for n in ("k", "v")})
        elif spec.mixer == "mla":
            caches.append({"ckv": z(li, "ckv", B, S_max, cfg.kv_lora_rank),
                           "krope": z(li, "krope", B, S_max,
                                      cfg.rope_head_dim)})
        elif spec.mixer == "mamba":
            h, conv = init_mamba_state(1, cfg.d_inner, cfg.ssm_state,
                                       cfg.d_conv, dtype, device)
            caches.append({"h": z(li, "h", B, cfg.d_inner, cfg.ssm_state,
                                  dt=h.dtype),
                           "conv": z(li, "conv", B, cfg.d_conv - 1,
                                     cfg.d_inner, dt=conv.dtype)})
        else:
            caches.append({})
    return caches


def _decode_rows(token, ctx: Ctx, specs):
    """(this rank's rows of ``token``, the data group to gather the logits'
    rows over): the rows are cut where the cache splits its batch."""
    if specs is None or ctx.n_dp == 1:
        return token, None
    first = next((s for c in specs for s in c.values()), None)
    if first is None or ctx.split_of(first, 1)[1] == 1:
        return token, None
    return ctx.rows(token), ctx.dp_group()


def decode_step(params, cache, token, pos, cfg: ModelConfig, ctx=None):
    """token: (B, 1) int; pos: the position (an int or a 0-d tensor).
    Returns (logits (B, V) float32, cache), the cache updated in place.
    Under ``ctx``'s layout ``cache`` is this rank's block of the cache
    ``init_cache(..., layout=)`` places, ``token`` the global batch, and
    the logits whole on every rank."""
    with trace.span("lm.decode"):
        return _decode_step(params, cache, token, pos, cfg,
                            NO_CTX if ctx is None else ctx)


def _decode_step(params, cache, token, pos, cfg: ModelConfig, ctx: Ctx):
    one_device(cfg, ctx.layout)
    pos = as_pos(pos, token.device)
    specs = _cache_specs(cfg, token.shape[0], ctx)
    token, rows_group = _decode_rows(token, ctx, specs)
    x = embed_tokens(params["embed"], token, act_dtype(params), ctx)
    lead = 1 if cfg.n_dense_lead else 0
    for g in range(cfg.n_dense_lead):
        x, _, _ = _apply_layer(x, group_slice(params["lead"], g),
                               cfg.lead_spec, cfg,
                               cache=group_slice(cache[0], g), pos=pos)
    for g in range(cfg.n_groups):
        for li, spec in enumerate(cfg.pattern):
            c = cache[lead + li]
            gc = group_slice(c, g) if c else None
            x, _, _ = _apply_layer(x, group_slice(params["groups"][li], g),
                                   spec, cfg, cache=gc, pos=pos, ctx=ctx,
                                   cspec=None if specs is None else
                                   _layer_spec(specs[li]))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_of(params, x[:, 0, :], ctx)
    return all_gather_dim(logits, rows_group, 0), cache


def _layer_spec(specs: dict):
    """The spec standing for a layer's cache leaves (their first: every
    leaf of a layer splits its batch and its sequence, or d_inner, on
    the same axes, dimensions 1 and 2 of the stacked (G, B, ...) leaf)."""
    for s in specs.values():
        return tuple(s)
    return None


def _cut_piece(t, spec, ctx: Ctx, dims):
    """A prefill cache leaf (G, ...) cut to this rank's block along the
    dimensions ``dims`` of ``spec`` that split it."""
    for dim, names in sharded_dims(spec, ctx.layout):
        if dim in dims:
            n, k = ctx.layout.size(names), ctx.layout.index(names)
            if t.shape[dim] % n:
                raise ValueError(f"a prefill cache of {t.shape[dim]} rows "
                                 f"does not split over {n} ranks")
            step = t.shape[dim] // n
            t = t.narrow(dim, k * step, step)
    return t.contiguous()


def prefill(params, tokens, cfg: ModelConfig, S_cache: int, patches=None,
            ctx=None):
    """Forward pass that also returns the per-layer cache, in the
    reference's layout: a windowed layer keeps the *last* ``min(w, S)``
    positions at rows 0.., a full layer keeps S rows (``S_cache`` is
    unused), a Mamba layer its final state. Returns (last hidden, cache).
    Under ``ctx``'s layout the tokens are the global batch and the cache
    this rank's block of it by ``launch.shapes.cache_pspecs`` (its
    sequence split over the ranks; the batch over the data ranks where
    they divide it). Leading dense layers put their entry first."""
    with trace.span("lm.prefill"):
        return _prefill(params, tokens, cfg, patches,
                        NO_CTX if ctx is None else ctx)


def _prefill(params, tokens, cfg: ModelConfig, patches, ctx: Ctx):
    one_device(cfg, ctx.layout)
    specs = _cache_specs(cfg, tokens.shape[0], ctx)
    tokens, rows_group = _decode_rows(tokens, ctx, specs)
    if rows_group is not None and patches is not None:
        patches = ctx.rows(patches)
    x = _inputs(params, tokens, patches, ctx)
    S = x.shape[1]
    mode = _tp_mode(cfg, ctx)
    lead = []
    for g in range(cfg.n_dense_lead):
        x, piece, _ = _apply_layer(x, group_slice(params["lead"], g),
                                   cfg.lead_spec, cfg)
        lead.append(piece)
    per_group = [[] for _ in cfg.pattern]
    for g in range(cfg.n_groups):
        for li, spec in enumerate(cfg.pattern):
            x, piece, _ = _apply_layer(
                x, group_slice(params["groups"][li], g), spec, cfg, ctx=ctx)
            if spec.mixer == "attn":
                if mode == "head_dim":
                    piece = {k: ctx.gather(v, 3) for k, v in piece.items()}
                if spec.window:
                    w = min(spec.window, S)
                    piece = {k: v[:, -w:] for k, v in piece.items()}
            per_group[li].append(piece or {})
    cache = [{k: torch.stack([pg[k] for pg in pieces])
              for k in pieces[0]} for pieces in ([lead] if lead else [])
             + per_group]
    if specs is not None:
        # the sequence (attention, MLA) is cut here; a Mamba state is
        # already this rank's block of d_inner
        cache = [{k: (_cut_piece(v, specs[li][k], ctx, (2,))
                      if cfg.pattern[li].mixer != "mamba" else v)
                  for k, v in c.items()} for li, c in enumerate(cache)]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return all_gather_dim(x[:, -1, :].contiguous(), rows_group, 0), cache
