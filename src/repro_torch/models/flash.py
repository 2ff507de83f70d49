"""Flash attention's forward (the port of ``repro.models.flash``).

The reference wraps this forward in a custom VJP that saves only (q, k, v,
out, lse) and recomputes the probabilities per KV chunk in the backward.
Its output equals ``layers.attention``'s (the same chunk loop), so the
serving path calls ``attention`` and nothing calls this yet: it comes
onto the training path with the backward, which needs ``lse``. Supports
GQA (Hq % Hkv == 0), MLA's dv != hd, causal and sliding-window masks.
"""
from __future__ import annotations

import torch

from .layers import chunk_bias, kv_chunk_len, online_softmax, scale_in


def _flash_fwd_impl(q, k, v, causal, window, q_offset, kv_chunk, scale):
    """q: (B,Sq,Hq,hd); k: (B,Skv,Hkv,hd); v: (B,Skv,Hkv,dv) ->
    (out (B,Sq,Hq,dv) in q's dtype, lse (B,Sq,Hkv,G) float32)."""
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


def flash_attention(q, k, v, causal=True, window=None, q_offset=0,
                    kv_chunk=1024, scale=None):
    """q: (B,Sq,Hq,hd); k: (B,Skv,Hkv,hd); v: (B,Skv,Hkv,dv) -> (B,Sq,Hq,dv)."""
    out, _ = _flash_fwd_impl(q, k, v, causal, window, q_offset, kv_chunk,
                             scale)
    return out
