"""Mixture-of-Experts FFN (the port of ``repro.models.moe``).

Tokens are routed to their top-k experts, packed into a per-expert buffer
of ``capacity`` rows in arrival order (tokens past capacity drop, GShard
style), run through the experts' gated FFNs, and combined with the
renormalised router weights.

``dropless=True`` (a published checkpoint's inference, ``PublishedConfig.
moe_dropless``; local path only) computes every assignment: the (token,
expert) pairs are sorted by expert and each expert's run of rows goes
through one grouped product (``torch._grouped_mm`` over device-side
offsets), with no capacity buffer and no read of the counts on the host;
it takes the router's logits in float32 from float32 operands, as the
published modelling code does. ``renorm`` is ``norm_topk_prob``.

``ep_axis=None`` is the local path: every expert on this device.
``ep_axis="data"`` with a ``launch.mesh.Layout`` is the reference's
expert-parallel ``run(..., n_data, e_div)``: the tokens are this rank's
rows, the rank holds experts [k E / n, (k + 1) E / n) of the n ranks
along the axis (its rows of ``gate`` / ``up`` / ``down``), the capacity
comes from the rank's own tokens, the (n, E / n, C, d) buffer goes out by
an all-to-all, the rank's experts run on every rank's rows, and the
results come back by the inverse all-to-all. The layer is recomputed in
the backward (the reference's ``jax.checkpoint`` inside its shard_map),
and the exchange's backward is the inverse exchange (``_Exchange``).
Over the model ranks (``tp_group``, the model axis's group) each
expert's ff dimension is split, so the experts' outputs are partial sums: the combine is
linear in them, and its result is summed over the model ranks after it
(the reference's psum over "model", ``moe.py:126``). The local path
sums too: the reference computes it under GSPMD on the same split
weights. The router is replicated; the tokens and the routing weights
enter the split experts through ``copy_to``, so their gradients (and the
replicated router's) come out whole on every model rank.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.launch.mesh import copy_to, exchange, reduce_from
from .layers import rematerialize


def _router(x, w_router, top_k: int, renorm: bool = True):
    """x: (N, d) -> (ids (N, k), weights (N, k), aux load-balance loss).

    The top-k takes the lower expert index first among equal
    probabilities (``lax.top_k``'s order), through a stable descending
    sort; ``torch.topk`` leaves the order of ties unspecified. ``renorm``
    makes the k weights sum to 1; the weights come back in x's dtype."""
    logits = (x @ w_router).float()                      # (N, E)
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :top_k], ids[:, :top_k]
    if renorm:
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


def _expert_rows(ids, n_experts: int) -> torch.Tensor:
    """Rows an expert: (E,) int64 counts of ``ids``, on the device
    (``torch.bincount`` reads its input's max on the host)."""
    flat = ids.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.long,
                       device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _count_routing(ids, n_experts: int) -> None:
    """The recorder's routing counters of one layer-step: assignments
    (a host int from the shape), and the most rows any expert got and the
    experts given any, as device tensors."""
    rows = _expert_rows(ids, n_experts)
    trace.count("moe.assignments", ids.numel())
    trace.count("moe.expert_rows_max", rows.max())
    trace.count("moe.experts_touched", (rows > 0).sum())


def _dropless(xf, ids, wts, w_gate, w_up, w_down):
    """Every assignment's expert output, weighted and summed per token.
    xf: (N, d); ids / wts: (N, k) (wts float32); expert weights (E, d, ff)
    / (E, ff, d). The N k rows are sorted by expert (stable: a token's
    rows keep their order) and each expert's run goes through one grouped
    product; the offsets stay on the device."""
    N, k = ids.shape
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    ends = torch.cumsum(_expert_rows(ids, w_gate.shape[0]),
                        0).to(torch.int32)
    with trace.span("moe.experts"):
        xs = xf[order // k]
        h = F.silu(torch._grouped_mm(xs, w_gate, offs=ends)) \
            * torch._grouped_mm(xs, w_up, offs=ends)
        ys = torch._grouped_mm(h, w_down, offs=ends)
        y = torch.empty_like(ys)
        y[order] = ys
        return (y.reshape(N, k, -1).float() * wts[..., None]).sum(dim=1)


def capacity(capacity_factor: float, top_k: int, n_tokens: int,
             n_experts: int) -> int:
    """Rows per expert: ``max(8, round(cf * k * N / E))`` with Python's
    round (half to even)."""
    return int(max(8, round(capacity_factor * top_k * n_tokens
                            / n_experts)))


class _Exchange(torch.autograd.Function):
    """``launch.mesh.exchange`` over a group, whose backward sends the
    gradient rows back where they came from (the same exchange)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return exchange(g, ctx.group), None


def _combine(ye, ids, wts, slot, valid, cap: int, N: int, d: int):
    """Each token's top-k expert rows of ``ye`` (E * cap, d), weighted by
    the router and summed; dropped assignments add nothing."""
    top_k = ids.shape[1]
    flat_valid = valid.reshape(-1)
    rows = torch.where(flat_valid, ids.reshape(-1) * cap + slot.reshape(-1),
                       torch.zeros_like(slot.reshape(-1)))
    g = ye[rows]
    g = torch.where(flat_valid[:, None], g, torch.zeros_like(g))
    return torch.sum(g.reshape(N, top_k, d) * wts[..., None], dim=1)


def _ep_run(xl, router, wg, wu, wd, *, n_experts, top_k, capacity_factor,
            group, n_data, tp_group=None):
    """The reference's ``run`` on this rank's tokens ``xl`` (N_loc, d) and
    its ``n_experts / n_data`` experts; returns (out, aux)."""
    N, d = xl.shape
    e_loc = n_experts // n_data
    ids, wts, aux = _router(xl, router, top_k)
    cap = capacity(capacity_factor, top_k, N, n_experts)
    buf, slot, valid = _pack(copy_to(xl, tp_group), ids, n_experts, cap)
    buf = _Exchange.apply(buf.reshape(n_data, e_loc, cap, d), group)
    # axis 0 = the source rank; this rank's experts see every rank's rows
    buf = buf.transpose(0, 1).reshape(e_loc, n_data * cap, d)
    ye = _expert_ffn(buf, wg, wu, wd)
    ye = ye.reshape(e_loc, n_data, cap, d).transpose(0, 1)
    ye = _Exchange.apply(ye, group).reshape(n_experts * cap, d)
    out = _combine(ye, ids, copy_to(wts, tp_group), slot, valid, cap, N, d)
    return reduce_from(out, tp_group).to(xl.dtype), aux


def moe_ffn(x: torch.Tensor, params: dict, *, n_experts: int, top_k: int,
            capacity_factor: float, layout=None,
            ep_axis: Optional[str] = None, tp_group=None,
            dropless: bool = False, renorm: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: (B, S, d) -> (out, aux_loss (scalar)).

    params: router (d, E), gate / up (E, d, ff), down (E, ff, d); under
    ``ep_axis`` the expert leaves hold this rank's E / n experts and the
    aux loss is this rank's tokens'; under ``tp_group`` their ff dimension
    is this rank's block. ``dropless`` / ``renorm``: the module's
    docstring (``dropless`` on the local path, one rank).
    """
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    if ep_axis is not None:
        n_data = layout.size(ep_axis)
        if n_experts % n_data:
            raise ValueError(f"{n_experts} experts do not split over "
                             f"{n_data} ranks of {ep_axis!r}")

        def run(xl, router, wg, wu, wd):
            return _ep_run(xl, router, wg, wu, wd, n_experts=n_experts,
                           top_k=top_k, capacity_factor=capacity_factor,
                           group=layout.group(ep_axis), n_data=n_data,
                           tp_group=tp_group)

        out, aux = rematerialize(run, xf, params["router"], params["gate"],
                                 params["up"], params["down"])
        return out.reshape(B, S, d), aux
    N = xf.shape[0]
    if dropless:
        with trace.span("moe.route"):
            ids, wts, aux = _router(xf.float(), params["router"].float(),
                                    top_k, renorm)
            if trace.ON:
                _count_routing(ids, n_experts)
        out = _dropless(xf, ids, wts, params["gate"], params["up"],
                        params["down"])
        return out.to(x.dtype).reshape(B, S, d), aux
    # three arguments where renorm holds: tests/torch_train_helpers.py and
    # chip_smoke.py wrap ``_router`` with that signature
    routing = {} if renorm else {"renorm": False}
    ids, wts, aux = _router(xf, params["router"], top_k, **routing)
    cap = capacity(capacity_factor, top_k, N, n_experts)
    buf, slot, valid = _pack(copy_to(xf, tp_group), ids, n_experts, cap)
    ye = _expert_ffn(buf, params["gate"], params["up"], params["down"])
    ye = ye.reshape(n_experts * cap, d)
    out = reduce_from(_combine(ye, ids, copy_to(wts, tp_group), slot, valid,
                               cap, N, d), tp_group)
    return out.to(x.dtype).reshape(B, S, d), aux
