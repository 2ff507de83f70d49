"""Flash attention with a hand-written backward (the port of
``repro.models.flash``).

The forward is the chunked online softmax of ``layers.attention`` (the
same loop, so the same output) that also returns the float32 log-sum-exp
of every row. The backward saves only (q, k, v, out, lse) and recomputes
the probabilities per KV chunk, as the reference's custom VJP does:

    delta = rowsum(dout * out)                 (float32 sums)
    p  = exp(s - lse),  dp = dout v^T,  ds = p (dp - delta)
    dq = sum over chunks of ds k * scale,  dk = ds^T (q * scale),
    dv = p^T dout

``q * scale`` is what the scores are formed from, so dk takes no extra
factor. Supports GQA (Hq % Hkv == 0), MLA's dv != hd, causal and
sliding-window masks. Decode (``kv_len`` masking) keeps using
``layers.attention``: nothing differentiates it.
"""
from __future__ import annotations

import torch

from .layers import (acc_dtype, chunk_bias, kv_chunk_len, online_softmax,
                     scale_in)


def _flash_fwd_impl(q, k, v, causal, window, q_offset, kv_chunk, scale):
    """q: (B,Sq,Hq,hd); k: (B,Skv,Hkv,hd); v: (B,Skv,Hkv,dv) ->
    (out (B,Sq,Hq,dv) in q's dtype, lse (B,Sq,Hkv,G) in
    ``acc_dtype(q)``, float32 for bf16 and float32 inputs)."""
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = Hq // Hkv
    sc = scale if scale is not None else hd ** -0.5
    ck = kv_chunk_len(Skv, kv_chunk)
    qh = scale_in(q, sc).reshape(B, Sq, Hkv, G, hd)
    m, l, acc = online_softmax(
        qh, k, v, ck, lambda ci: chunk_bias(Sq, ck, ci, q_offset, causal,
                                            window, None, q.device))
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    out = (acc / torch.clamp_min(l[..., None], 1e-30)
           ).reshape(B, Sq, Hq, dv).to(q.dtype)
    return out, lse


def _flash_bwd(causal, window, q_offset, kv_chunk, scale, res, dout):
    """(dq, dk, dv) in q's, k's and v's dtypes from the saved (q, k, v,
    out, lse) and the output's cotangent ``dout``; sums in
    ``acc_dtype(q)`` (float32 for bf16 and float32 inputs)."""
    q, k, v, out, lse = res
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = Hq // Hkv
    sc = scale if scale is not None else hd ** -0.5
    ck = kv_chunk_len(Skv, kv_chunk)
    f = acc_dtype(q)
    qh = scale_in(q, sc).reshape(B, Sq, Hkv, G, hd).to(f)
    og = out.reshape(B, Sq, Hkv, G, dv)
    dog = dout.reshape(B, Sq, Hkv, G, dv).to(f)
    delta = torch.sum(dog * og.to(f), dim=-1)
    dq = torch.zeros((B, Sq, Hkv, G, hd), dtype=f, device=q.device)
    dks, dvs = [], []
    for ci in range(Skv // ck):
        kci = k[:, ci * ck:(ci + 1) * ck].to(f)
        vci = v[:, ci * ck:(ci + 1) * ck].to(f)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qh, kci) + chunk_bias(
            Sq, ck, ci, q_offset, causal, window, None, q.device)
        p = torch.exp(s - lse[..., None])                    # (B,Sq,h,G,ck)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, vci)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kci) * sc
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qh))
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dog))
    return (dq.reshape(B, Sq, Hq, hd).to(q.dtype),
            torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_chunk, scale):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, q_offset,
                                   kv_chunk, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, kv_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        return _flash_bwd(*ctx.args, ctx.saved_tensors, dout) + (None,) * 5


def flash_attention(q, k, v, causal=True, window=None, q_offset=0,
                    kv_chunk=1024, scale=None):
    """q: (B,Sq,Hq,hd); k: (B,Skv,Hkv,hd); v: (B,Skv,Hkv,dv) -> (B,Sq,Hq,dv)
    in q's dtype, differentiable in q, k and v through ``_flash_bwd``."""
    return _Flash.apply(q, k, v, causal, window, q_offset, kv_chunk, scale)
