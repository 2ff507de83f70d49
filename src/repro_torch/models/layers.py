"""Shared building blocks: norms, RoPE, chunked attention, gated MLP (the
port of ``repro.models.layers``).

Everything is functional (parameters passed explicitly, stacked over the
groups by the callers). Attention streams KV in chunks with an online
softmax, so the (S x S) score matrix is never built beyond one chunk;
sliding-window locality is a mask on the same loop. The arithmetic keeps
the reference's dtypes step by step: ``q * scale`` in the input dtype,
scores and accumulators in float32, probabilities cast to V's dtype before
the second product, the additive ``NEG_INF`` mask.

``FLAGS`` are the reference's trace-time flags, read when a model is
called (the dry run, ``launch/dryrun.py``, sets them): ``flash`` (the
attention without a cache through ``flash.flash_attention``, or
``attention`` itself), ``remat_policy`` ("minimal" recomputes a whole
group in the backward; "save_tp" keeps the outputs of the group's
tensor-parallel all-reduces, ``launch.mesh.reduce_from``, so the
recompute issues none), ``kv_chunk`` (overrides every attention's KV
chunk) and ``mamba_chunk`` (the selective scan's chunk). The reference
also has ``unroll_inner``, because XLA's cost analysis counts a loop body
once and its probes unroll every inner scan; the port's loops are Python
loops, which ``FlopCounterMode`` counts at every iteration, so it has no
such flag. At their defaults the flags change nothing.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.launch.mesh import all_reduce_

NEG_INF = -1.0e30

FLAGS = {"mamba_chunk": 16, "kv_chunk": None, "flash": True,
         "remat_policy": "minimal"}


def set_probe_mode(on: bool, mamba_chunk: int = 512, kv_chunk: int = 4096):
    """The dry run's cost probes: fewer, fatter attention and scan chunks
    (the reference's ``set_probe_mode``); ``on=False`` restores the
    defaults."""
    FLAGS["mamba_chunk"] = mamba_chunk if on else 16
    FLAGS["kv_chunk"] = kv_chunk if on else None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMS norm scaled by ``1 + scale`` (the scales are zero-initialised),
    computed in float32 and cast back to ``x``'s dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         pair_offset: int = 0, half_total: Optional[int] = None,
         freqs: Optional[torch.Tensor] = None):
    """Interleaved (rotate-every-two) RoPE: pairs are (2i, 2i + 1), not the
    half-split layout. Frequencies and angles in float32, the result cast
    back to ``x``'s dtype. x: (..., S, H, hd); positions: (..., S).

    A block of head_dim (tensor parallelism over it, ``attn_shard=
    "head_dim"``) holds pairs ``pair_offset ..`` of a head of
    ``half_total`` pairs; interleaving keeps every pair inside one
    block, and each pair gets the frequency of its place in the head.
    ``freqs`` (hd / 2 float32 values, ``yarn_freqs``) replaces the
    frequencies of ``theta``."""
    hd = x.shape[-1]
    half = hd // 2
    total = half if half_total is None else half_total
    if freqs is None:
        exps = -torch.arange(pair_offset, pair_offset + half,
                             dtype=torch.float32, device=x.device) / total
        freqs = torch.pow(theta, exps)      # float32: theta ** exps
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x2 = x.reshape(x.shape[:-1] + (half, 2))
    xe, xo = x2[..., 0], x2[..., 1]
    re = xe * cos - xo * sin
    ro = xe * sin + xo * cos
    return torch.stack([re, ro], dim=-1).reshape(x.shape).to(x.dtype)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention factor ``0.1 mscale ln(factor) + 1`` (1 at factor
    <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_freqs(yarn, dim: int, base: float, device) -> torch.Tensor:
    """The dim / 2 float32 RoPE frequencies of YaRN (DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``): ``base ** (-2i / dim)`` above the
    correction range of ``yarn.beta_fast`` rotations over
    ``yarn.original`` positions, divided by ``yarn.factor`` below that of
    ``yarn.beta_slow``, and a linear ramp between."""
    def corr(rot):
        return dim * math.log(yarn.original / (rot * 2 * math.pi)) / (
            2 * math.log(base))

    lo = max(math.floor(corr(yarn.beta_fast)), 0)
    hi = min(math.ceil(corr(yarn.beta_slow)), dim - 1)
    hi = hi + 0.001 if lo == hi else hi
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim)
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - lo) / (hi - lo), 0, 1)
    return extra / yarn.factor * ramp + extra * (1.0 - ramp)


def scale_in(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x * scale`` in ``x``'s dtype with the scale first rounded to that
    dtype (on the host, whatever the default device), as jnp does with a
    Python scalar."""
    return x * float(torch.tensor(scale, dtype=x.dtype, device="cpu"))


def kv_chunk_len(Skv: int, kv_chunk: int) -> int:
    """The KV chunk: ``kv_chunk`` (``FLAGS["kv_chunk"]`` where set) where
    it divides Skv, else one chunk."""
    kv_chunk = FLAGS["kv_chunk"] or kv_chunk
    return kv_chunk if Skv % kv_chunk == 0 else Skv


def chunk_bias(Sq: int, ck: int, ci: int, q_offset, causal: bool,
               window: Optional[int], kv_len: Optional[torch.Tensor],
               device) -> torch.Tensor:
    """The additive float32 mask of KV chunk ``ci``, broadcastable to the
    scores (B, Sq, Hkv, G, ck)."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    kv_pos = ci * ck + torch.arange(ck, device=device)
    mask = torch.ones((Sq, ck), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= q_pos[:, None] - kv_pos[None, :] < window
    if kv_len is not None:
        mask = mask[None] & (kv_pos[None, None, :] < kv_len[:, None, None])
        mask = mask[:, :, None, None, :]
    else:
        mask = mask[None, :, None, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype attention's scores and sums are kept in: float32 for
    bf16 and float32 inputs (the reference's), float64 for float64."""
    return torch.promote_types(x.dtype, torch.float32)


def online_softmax(qh, k, v, ck: int, bias_of):
    """The chunk loop both attentions share. qh: (B, Sq, Hkv, G, hd),
    already scaled; k: (B, Skv, Hkv, hd); v: (B, Skv, Hkv, dv);
    ``bias_of(ci)`` the mask of chunk ci. Returns the running max m,
    normaliser l and accumulator acc in ``acc_dtype(qh)``."""
    B, Sq, Hkv, G, _ = qh.shape
    dv = v.shape[-1]
    f = acc_dtype(qh)
    qf = qh.to(f)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=f, device=qh.device)
    l = torch.zeros((B, Sq, Hkv, G), dtype=f, device=qh.device)
    acc = torch.zeros((B, Sq, Hkv, G, dv), dtype=f, device=qh.device)
    for ci in range(k.shape[1] // ck):
        kci = k[:, ci * ck:(ci + 1) * ck]
        vci = v[:, ci * ck:(ci + 1) * ck]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kci.to(f)) + bias_of(ci)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vci.dtype).to(f), vci.to(f))
        m = m_new
    return m, l, acc


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              *, causal: bool = True,
              window: Optional[int] = None,
              q_offset=0,
              kv_chunk: int = 1024,
              kv_len: Optional[torch.Tensor] = None,
              scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax chunked attention with GQA and an optional sliding
    window.

    q: (B, Sq, Hq, hd);  k: (B, Skv, Hkv, hd);  v: (B, Skv, Hkv, dv)
    (dv may differ from hd — MLA). Hq % Hkv == 0; the query heads of one
    KV head are adjacent (``Hq`` reshaped to ``(Hkv, G)``).
    q_offset: absolute position of q[0] (decode: current position).
    kv_len: optional (B,) valid KV length (decode with a ring or partial
    cache). Returns (B, Sq, Hq, dv) in q's dtype.
    """
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = Hq // Hkv
    scale = scale if scale is not None else hd ** -0.5
    qh = scale_in(q, scale).reshape(B, Sq, Hkv, G, hd)
    ck = kv_chunk_len(Skv, kv_chunk)
    m, l, acc = online_softmax(
        qh, k, v, ck, lambda ci: chunk_bias(Sq, ck, ci, q_offset, causal,
                                            window, kv_len, q.device))
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, Hq, dv).to(q.dtype)


def gated_mlp(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def _save_all_reduce(ctx, func, *args, **kwargs):
    """The "save_tp" policy: an all-reduce's output is kept, everything
    else recomputed."""
    if func is torch.ops.c10d.allreduce_.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def rematerialize(fn, *args, save_tp: bool = False):
    """``fn(*args)``, its activations recomputed in the backward
    (``jax.checkpoint``) where autograd records it; a plain call
    otherwise. With ``save_tp`` the outputs of the all-reduces inside
    ``fn`` are saved and the recompute reuses them."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if save_tp:
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_save_tp_contexts)
    return checkpoint(fn, *args, use_reentrant=False)


def _save_tp_contexts():
    return create_selective_checkpoint_contexts(_save_all_reduce)


def _chunk_nll(h, emb, t, m):
    """Masked next-token NLL summed over one chunk: float32 logits of the
    tied unembedding, logsumexp minus the gold logit."""
    logits = (h @ emb.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return torch.sum((lse - gold) * m)


def _chunk_nll_split(h, emb, t, m, ctx):
    """``_chunk_nll`` with ``emb`` this rank's rows of a vocabulary split
    over the model ranks of ``ctx`` (rank k holds rows [k V / n, (k + 1)
    V / n)): the row max, the sum of exponentials and the target's logit
    each summed (the max: maxed) over the ranks. The hidden states enter
    through ``ctx.copy``, so their gradient is summed over the ranks; the
    embedding's stays this rank's."""
    logits = (ctx.copy(h) @ emb.T).float()                # (B, ck, V / n)
    mx = all_reduce_(logits.detach().amax(dim=-1), ctx.tp_group, "max")
    se = ctx.reduce(torch.exp(logits - mx[..., None]).sum(dim=-1))
    lse = mx + torch.log(se)
    local = t - ctx.tp_rank * emb.shape[0]
    inside = (local >= 0) & (local < emb.shape[0])
    gold = torch.gather(logits, -1, local.clamp(0, emb.shape[0] - 1)[
        ..., None])[..., 0]
    gold = ctx.reduce(torch.where(inside, gold, torch.zeros_like(gold)))
    return torch.sum((lse - gold) * m)


def chunked_cross_entropy(hidden: torch.Tensor, emb: torch.Tensor,
                          targets: torch.Tensor, mask: torch.Tensor,
                          s_chunk: int = 512, ctx=None) -> torch.Tensor:
    """Mean next-token CE without materializing full (B, S, V) logits.

    hidden: (B, S, d); emb: (V, d) tied unembedding; targets / mask:
    (B, S), the mask float32. The sequence is cut into chunks of the
    largest divisor of S that is at most ``s_chunk``; each chunk's float32
    logits are recomputed in the backward (``rematerialize``), so autograd
    keeps none of them. Returns the float32 mean over the mask's count (at
    least 1). With ``ctx`` (an ``lm.Ctx`` whose model axis has more than
    one rank) ``emb`` is this rank's block of the vocabulary
    (``_chunk_nll_split``).
    """
    S = hidden.shape[1]
    ck = min(s_chunk, S)
    while S % ck:          # largest divisor of S <= s_chunk (VLM: S=3840)
        ck -= 1
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, ck):
        m = mask[:, c0:c0 + ck]
        if ctx is not None and ctx.tp > 1:
            nll = rematerialize(_chunk_nll_split, hidden[:, c0:c0 + ck],
                                emb, targets[:, c0:c0 + ck], m, ctx)
        else:
            nll = rematerialize(_chunk_nll, hidden[:, c0:c0 + ck], emb,
                                targets[:, c0:c0 + ck], m)
        tot = tot + nll
        cnt = cnt + torch.sum(m)
    return tot / torch.clamp_min(cnt, 1.0)
