"""The plain reference of DeepSeek-V2's causal forward pass (DeepSeek-V2-Lite
when given its configuration): float32, plain ``torch``, no cache, no
batching tricks, one layer at a time.

It follows the published modelling code (``modeling_deepseek.py`` beside
the checkpoint's ``config.json``; arXiv:2405.04434) and reads the
configuration by its published keys:

- MLA, unabsorbed: ``q_proj`` to H x (nope + rope); ``kv_a_proj_with_mqa``
  to the 512-wide latent and the 64-wide shared rope key; RMSNorm on the
  latent; ``kv_b_proj`` to H x (nope + v); softmax scale (nope + rope) **
  -0.5 times ``mscale(factor, mscale_all_dim) ** 2``; causal softmax in
  float32; ``o_proj``.
- RoPE as the published code applies it: each rope part de-interleaved
  (columns 0, 2, 4, .. then 1, 3, 5, ..) and rotated by halves, with YaRN's
  frequencies (``DeepseekV2YarnRotaryEmbedding``: the linear ramp between
  the correction dims of ``beta_fast`` and ``beta_slow`` rotations over
  ``original_max_position_embeddings``, frequencies divided by ``factor``
  below it) and cos / sin scaled by ``mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)``. A program that rotates interleaved
  pairs (2i, 2i + 1) of the same columns computes the same q and k up to
  one permutation of the rope columns, the same for both, so its scores
  equal these.
- MoE: softmax over the routed experts of float32 logits, greedy top-k,
  renormalised only under ``norm_topk_prob``, times
  ``routed_scaling_factor``; each expert run on its own tokens in a loop
  over the experts; the shared experts one gated MLP of width
  ``n_shared_experts x moe_intermediate_size``.
- The first ``first_k_dense_replace`` layers a gated MLP of width
  ``intermediate_size``; an untied head (``tie_word_embeddings`` false).

The weights are the published checkpoint's, by its keys and layouts
(``nn.Linear`` weights (out, in), RMSNorm weights multiplied in as
given), drawn from a seed as the published modelling code initialises
them (``_init_weights``: normal of std ``initializer_range`` for every
linear and embedding weight, RMSNorm weights at 1; ``draw_outer``,
``draw_layer``): the embedding, final norm and head from one generator,
each layer from its own, so that a layer is drawn again alone. A layer's
dict holds its ``model.layers.{i}.`` entries without that prefix:

    input_layernorm.weight (d,), self_attn.q_proj.weight (H (nope + rope),
    d), self_attn.kv_a_proj_with_mqa.weight (r + rope, d),
    self_attn.kv_a_layernorm.weight (r,), self_attn.kv_b_proj.weight
    (H (nope + v), r), self_attn.o_proj.weight (d, H v),
    post_attention_layernorm.weight (d,), then a dense layer's
    mlp.{gate,up}_proj.weight (ff, d), mlp.down_proj.weight (d, ff), or an
    MoE layer's mlp.gate.weight (E, d), mlp.experts.{e}.{gate,up}_proj.
    weight (ff, d), mlp.experts.{e}.down_proj.weight (d, ff) and
    mlp.shared_experts.{gate,up,down}_proj.weight.

The forward pass widens each part to float32 as it is reached. Nothing
here imports the program under test. TF32 is switched off for the
process's float32 products by ``no_tf32``.
"""
from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Keep the card's float32 products in float32 (not TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, w, eps: float):
    var = x.pow(2).mean(dim=-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def inv_freq(cfg: dict, device) -> torch.Tensor:
    """The rope part's frequencies (dim / 2), YaRN-scaled where the
    configuration's ``rope_scaling`` is of type "yarn"."""
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    extra = 1.0 / base ** (ar / dim)
    y = cfg.get("rope_scaling")
    if not y:
        return extra
    assert y["type"] == "yarn", y
    factor = float(y["factor"])
    inter = 1.0 / (factor * base ** (ar / dim))

    def corr(rot):
        return dim * math.log(y["original_max_position_embeddings"]
                              / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(corr(y["beta_fast"])), 0)
    hi = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - lo) / (hi - lo), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def cos_sin(cfg: dict, S: int, device):
    """(cos, sin), each (S, rope): the published cache, halves repeated."""
    f = torch.outer(torch.arange(S, dtype=torch.float32, device=device),
                    inv_freq(cfg, device))
    emb = torch.cat([f, f], dim=-1)
    y = cfg.get("rope_scaling") or {}
    amp = 1.0
    if y:
        amp = (yarn_mscale(y["factor"], y.get("mscale", 1))
               / yarn_mscale(y["factor"], y.get("mscale_all_dim", 0)))
    return emb.cos() * amp, emb.sin() * amp


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x, cos, sin):
    """x: (B, S, H, rope): de-interleave, then rotate by halves."""
    B, S, H, D = x.shape
    x = x.reshape(B, S, H, D // 2, 2).transpose(-1, -2).reshape(B, S, H, D)
    return x * cos[None, :, None] + _rotate_half(x) * sin[None, :, None]


def softmax_scale(cfg: dict) -> float:
    sc = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    y = cfg.get("rope_scaling") or {}
    if y.get("mscale_all_dim"):
        sc *= yarn_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return sc


def mla(x, w: dict, cfg: dict, cos, sin):
    """Multi-head latent attention over x (B, S, d), causal."""
    B, S, _ = x.shape
    H = cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    q = F.linear(x, w["self_attn.q_proj.weight"]).view(B, S, H, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    ckv = F.linear(x, w["self_attn.kv_a_proj_with_mqa.weight"])
    c, k_pe = ckv[..., :r], ckv[..., r:]
    kv = F.linear(rms_norm(c, w["self_attn.kv_a_layernorm.weight"],
                           cfg["rms_norm_eps"]),
                  w["self_attn.kv_b_proj.weight"]).view(B, S, H, nope + dv)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe[:, :, None, :], cos, sin)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(B, S, H, rope)], dim=-1)
    s = torch.einsum("bqhk,bthk->bhqt", qs, ks) * softmax_scale(cfg)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bthv->bqhv", a, v)
    return F.linear(o.reshape(B, S, H * dv), w["self_attn.o_proj.weight"])


def mlp(x, w: dict, prefix: str):
    """The gated MLP ``prefix``{gate,up,down}_proj of ``w``."""
    gate, up, down = (w[f"{prefix}{n}_proj.weight"]
                      for n in ("gate", "up", "down"))
    return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)


def moe(x, w: dict, cfg: dict):
    """Routed experts (each on its own tokens) plus the shared experts."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    scores = torch.softmax(F.linear(xf, w["mlp.gate.weight"]), dim=-1)
    wt, idx = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    if cfg["norm_topk_prob"]:
        wt = wt / wt.sum(dim=-1, keepdim=True)
    wt = wt * cfg["routed_scaling_factor"]
    out = torch.zeros_like(xf)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = mlp(xf[tok], w, f"mlp.experts.{e}.")
        out.index_add_(0, tok, y * wt[tok, slot, None])
    out = out + mlp(xf, w, "mlp.shared_experts.")
    return out.reshape(B, S, d)


def hidden(tokens, cfg: dict, outer: dict, layers):
    """Final hidden states (B, S, d) float32 of ``tokens`` (B, S) int:
    ``outer`` the float32 embedding and final norm, ``layers`` an
    iterable of the layers' float32 weight dicts in order (each may be
    made as it is reached)."""
    B, S = tokens.shape
    eps = cfg["rms_norm_eps"]
    embed = outer["model.embed_tokens.weight"]
    cos, sin = cos_sin(cfg, S, embed.device)
    x = embed[tokens]
    for i, w in enumerate(layers):
        x = x + mla(rms_norm(x, w["input_layernorm.weight"], eps), w, cfg,
                    cos, sin)
        h = rms_norm(x, w["post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + mlp(h, w, "mlp.")
        else:
            x = x + moe(h, w, cfg)
    assert i + 1 == cfg["num_hidden_layers"], i
    return rms_norm(x, outer["model.norm.weight"], eps)


def logits(h, head):
    """float32 logits of hidden states ``h`` (..., d) under the head (V,
    d)."""
    return h @ head.T


def _generator(seed: int, part: str, device) -> torch.Generator:
    """The generator of one part of the checkpoint drawn from ``seed``."""
    h = hashlib.sha256(f"{seed}/{part}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(h[:8], "little") >> 1)


def _draw(shapes: dict, cfg: dict, gen, dtype) -> dict:
    """``shapes``' entries in order: RMSNorm weights at 1, every other
    weight normal of std ``initializer_range``, drawn in float32 and
    cast to ``dtype``."""
    std = cfg["initializer_range"]
    return {k: torch.ones(shp, dtype=dtype, device=gen.device)
            if k.endswith("norm.weight") else
            (torch.randn(shp, generator=gen, device=gen.device) * std
             ).to(dtype)
            for k, shp in shapes.items()}


def outer_shapes(cfg: dict) -> dict:
    """The checkpoint's entries outside the layers, by key."""
    V, d = cfg["vocab_size"], cfg["hidden_size"]
    out = {"model.embed_tokens.weight": (V, d), "model.norm.weight": (d,)}
    if not cfg["tie_word_embeddings"]:
        out["lm_head.weight"] = (V, d)
    return out


def layer_shapes(cfg: dict, i: int) -> dict:
    """Layer ``i``'s entries, by key without ``model.layers.{i}.``."""
    assert cfg["q_lora_rank"] is None, "q-LoRA is not drawn here"
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    r, dv = cfg["kv_lora_rank"], cfg["v_head_dim"]
    out = {"input_layernorm.weight": (d,),
           "self_attn.q_proj.weight": (H * (nope + rope), d),
           "self_attn.kv_a_proj_with_mqa.weight": (r + rope, d),
           "self_attn.kv_a_layernorm.weight": (r,),
           "self_attn.kv_b_proj.weight": (H * (nope + dv), r),
           "self_attn.o_proj.weight": (d, H * dv),
           "post_attention_layernorm.weight": (d,)}

    def gated(prefix, ff):
        out.update({f"{prefix}gate_proj.weight": (ff, d),
                    f"{prefix}up_proj.weight": (ff, d),
                    f"{prefix}down_proj.weight": (d, ff)})

    if i < cfg["first_k_dense_replace"]:
        gated("mlp.", cfg["intermediate_size"])
        return out
    ff = cfg["moe_intermediate_size"]
    out["mlp.gate.weight"] = (cfg["n_routed_experts"], d)
    for e in range(cfg["n_routed_experts"]):
        gated(f"mlp.experts.{e}.", ff)
    gated("mlp.shared_experts.", cfg["n_shared_experts"] * ff)
    return out


def draw_outer(cfg: dict, seed: int, device, dtype) -> dict:
    """The embedding, the final norm and the head of weight seed
    ``seed``, in ``dtype`` on ``device``."""
    return _draw(outer_shapes(cfg), cfg, _generator(seed, "outer", device),
                 dtype)


def draw_layer(cfg: dict, seed: int, i: int, device, dtype) -> dict:
    """Layer ``i`` of weight seed ``seed``, in ``dtype`` on ``device``."""
    return _draw(layer_shapes(cfg, i), cfg,
                 _generator(seed, f"layer{i}", device), dtype)


def served_logits(cfg: dict, seed: int, tokens, first: int, dtype):
    """The float32 logits (B, S - first, V) at positions ``first``.. of
    the token rows ``tokens`` (B, S), under the checkpoint of weight seed
    ``seed`` drawn in ``dtype`` on the tokens' device, each part widened
    to float32 as it is reached."""
    dev = tokens.device

    def wide(w):
        return {k: v.float() for k, v in w.items()}

    outer = wide(draw_outer(cfg, seed, dev, dtype))
    layers = (wide(draw_layer(cfg, seed, i, dev, dtype))
              for i in range(cfg["num_hidden_layers"]))
    h = hidden(tokens, cfg, outer, layers)[:, first:]
    return logits(h, outer.get("lm_head.weight",
                               outer["model.embed_tokens.weight"]))
