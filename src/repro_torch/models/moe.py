"""Mixture-of-Experts FFN, the local path (the port of
``repro.models.moe`` with ``ep_axis=None``).

Tokens are routed to their top-k experts, packed into a per-expert buffer
of ``capacity`` rows in arrival order (tokens past capacity drop, GShard
style), run through every expert's gated FFN at once, and combined with
the renormalised router weights. The expert-parallel path of the
reference (a shard_map with all_to_all dispatch) waits for multi-card
model sharding.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _router(x, w_router, top_k: int):
    """x: (N, d) -> (ids (N, k), weights (N, k), aux load-balance loss).

    The top-k takes the lower expert index first among equal
    probabilities (``lax.top_k``'s order), through a stable descending
    sort; ``torch.topk`` leaves the order of ties unspecified."""
    logits = (x @ w_router).float()                      # (N, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    w = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style aux loss: E * <f_e * p_e>
    E = w_router.shape[1]
    fe = F.one_hot(ids[:, 0], E).float().mean(dim=0)
    pe = probs.mean(dim=0)
    aux = E * torch.sum(fe * pe)
    return ids, w.to(x.dtype), aux


def _pack(x, ids, n_experts: int, capacity: int):
    """The (E, C, d) expert buffer and the combine metadata.

    slot[i, j] is the row inside expert ids[i, j]'s capacity block, in
    arrival order over the flattened (N * k) ids; tokens past capacity
    drop (valid False)."""
    N, k = ids.shape
    flat_ids = ids.reshape(-1)                            # (N*k,)
    onehot = F.one_hot(flat_ids, n_experts)
    pos = torch.cumsum(onehot, dim=0) - 1                 # arrival order
    slot = torch.gather(pos, 1, flat_ids[:, None])[:, 0]
    valid = slot < capacity
    dest = torch.where(valid, flat_ids * capacity + slot,
                       torch.full_like(slot, n_experts * capacity))
    # scatter token indices; the rows move in one gather
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(k)
    buf_idx = torch.full((n_experts * capacity + 1,), N, dtype=torch.long,
                         device=x.device)
    buf_idx[dest] = tok_idx      # dropped tokens all land on the last row
    xz = torch.cat([x, x.new_zeros((1, x.shape[-1]))], dim=0)
    buf = xz[buf_idx[:-1]]                                # (E*C, d)
    return (buf.reshape(n_experts, capacity, -1),
            slot.reshape(N, k), valid.reshape(N, k))


def _expert_ffn(xe, w_gate, w_up, w_down):
    """xe: (E, C, d); weights (E, d, ff) / (E, ff, d) -> (E, C, d)."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, w_gate))
    h = h * torch.einsum("ecd,edf->ecf", xe, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def capacity(capacity_factor: float, top_k: int, n_tokens: int,
             n_experts: int) -> int:
    """Rows per expert: ``max(8, round(cf * k * N / E))`` with Python's
    round (half to even)."""
    return int(max(8, round(capacity_factor * top_k * n_tokens
                            / n_experts)))


def moe_ffn(x: torch.Tensor, params: dict, *, n_experts: int, top_k: int,
            capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN on one device. x: (B, S, d) -> (out, aux_loss (scalar)).

    params: router (d, E), gate / up (E, d, ff), down (E, ff, d).
    """
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    N = xf.shape[0]
    ids, wts, aux = _router(xf, params["router"], top_k)
    cap = capacity(capacity_factor, top_k, N, n_experts)
    buf, slot, valid = _pack(xf, ids, n_experts, cap)
    ye = _expert_ffn(buf, params["gate"], params["up"], params["down"])
    ye = ye.reshape(n_experts * cap, d)
    flat_valid = valid.reshape(-1)
    rows = torch.where(flat_valid, ids.reshape(-1) * cap + slot.reshape(-1),
                       torch.zeros_like(slot.reshape(-1)))
    g = ye[rows]
    g = torch.where(flat_valid[:, None], g, torch.zeros_like(g))
    out = torch.sum(g.reshape(N, top_k, d) * wts[..., None], dim=1)
    return out.to(x.dtype).reshape(B, S, d), aux
