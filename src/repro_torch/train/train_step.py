"""Train- and serve-step factories (the port of
``repro.train.train_step``).

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss's gradients by autograd, then one AdamW
step. ``batch`` is the global batch. With ``microbatch`` m > 1 the batch
is cut into m slices along its first axis, each slice's gradients are
summed into float32 buffers and divided by m (the reference's
``lax.scan`` with float32 accumulators), as is the loss. Metrics are the
loss and the gradients' float32 global norm.

Under a ``launch.mesh.Layout`` with n ranks along the data-parallel axes
(``lm.Ctx.dp``) the step is data-parallel, the counterpart of the
reference's SPMD step on its mesh:

- each rank computes on its rows of each slice (``Ctx.rows``), and its
  loss is the mean over them;
- ``grad_sync="per_microbatch"`` (the default) sums each slice's
  gradients over the data ranks, in their dtype, before they are
  accumulated; ``"deferred"`` accumulates the rank's m slices of its own
  rows in float32 and syncs once a step (the reference's ``shard_map``
  over the data axes);
- a leaf is summed over the data-parallel axes it is replicated on. An
  expert leaf (split over "data") is not: the dispatch exchange's
  backward already brought every rank's tokens to its owner, and under a
  pod axis it is summed over the pods. Then every leaf is divided by n
  (and m): each rank's loss is over its 1 / n of the rows;
- ``grad_compression="int8"`` makes the deferred sync an
  ``int8_all_reduce``; ``"int8_pod"`` (per microbatch, with a pod axis)
  syncs within each pod, then sums the pods' gradients through
  ``int8_all_reduce`` over the pod axis, as the reference does (a sum:
  the reference does not divide by the pod count); without a pod axis it
  is the plain step. Other combinations are the plain step, as in the
  reference;
- the loss is the mean over the data ranks, the grad norm sums the split
  leaves' squares over their ranks, and ``AdamW.update_`` steps each
  rank's own leaves (an expert's state lives on its owner).

Over the layout's model axis each rank holds its block of every leaf
the specs split over "model" and the loss is computed by the
tensor-parallel model (``lm.Ctx``); its gradients come out of autograd
already complete for this rank's blocks, and a leaf replicated over the
model ranks gets the same whole gradient on each. So the sync sums over
the data axes only, never over "model"; the grad norm adds a split
leaf's squares from its ranks and a replicated leaf's once.

Without a layout every rank is on its own (one device).

``accum_pspecs`` (the reference's ZeRO-2 path; specs leaf for leaf with
the parameters, ``AdamW.state_pspecs(..., zero1=True, ...).m``) keeps
the gradients in float32 accumulators split over "data" where the specs
add "data" to a leaf's own spec: each slice's gradients are
reduce-scattered over the data ranks in their dtype (and summed over a
pod axis after), added to the rank's block, and divided by m n as
above; the leaves the specs leave as they are take the plain sync. The
optimizer state is the blocks' (``opt.init(zero_blocks(...))``, placed
as ``state_pspecs(zero1=True)`` places it): each rank updates its block
of every such leaf, and the parameter is all-gathered back over the data
ranks. It takes the per-microbatch sync without compression; without
``accum_pspecs`` nothing of it runs.

``make_serve_step`` and ``make_prefill`` run under
``torch.inference_mode()``, under a layout on this rank's blocks of the
parameters and of the cache (``launch.shapes.cache_pspecs``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch.mesh import (all_gather_dim, all_reduce_,
                                     reduce_scatter_dim, sharded_dims,
                                     spec_axes)
from repro_torch.models.lm import Ctx
from repro_torch.pytree import tree_leaves, tree_map

from .optimizer import AdamW, BLOCK, _map_specs

GRAD_SYNCS = ("per_microbatch", "deferred")
COMPRESSIONS = (None, "int8", "int8_pod")


def int8_all_reduce(tree, group):
    """The reference's ``_int8_psum`` over ``group``, per leaf: the shared
    scale max(|g|_max, 1e-12) / 127 (in the leaf's dtype) through a MAX
    all-reduce, ``clip(round(g / scale), -127, 127)`` as int32 summed
    over the group, times the scale in float32, cast back. (The
    reference's first quantize-and-psum is dead code and is not
    copied.)"""
    def one(g):
        scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
        shared = all_reduce_(scale.float().reshape(1), group, "max")
        scale = shared[0].to(g.dtype)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int32)
        all_reduce_(q, group, "sum")
        return (q.float() * scale.float()).to(g.dtype)
    return tree_map(one, tree)


def grad_norm(grads, specs=None, layout=None) -> torch.Tensor:
    """sqrt of the sum of every gradient entry squared, in float32 (a
    block of ``BLOCK`` entries at a time). Under ``layout`` a leaf split
    over ranks (its entry of ``specs``, the partition specs in leaf
    order) adds its squares from every rank."""
    split = {}
    tot = None
    flat = tree_leaves(grads)
    for g, spec in zip(flat, specs or [()] * len(flat)):
        flat_g = g.reshape(-1)
        part = None
        for i in range(0, flat_g.numel(), BLOCK):
            sq = torch.sum(flat_g[i:i + BLOCK].to(torch.float32) ** 2)
            part = sq if part is None else part + sq
        names = tuple(a for _, n in sharded_dims(spec, layout) for a in n)
        if names:
            split[names] = part if names not in split else split[names] + part
        else:
            tot = part if tot is None else tot + part
    for names in sorted(split):
        part = all_reduce_(split[names].reshape(1), layout.group(names))[0]
        tot = part if tot is None else tot + part
    return torch.sqrt(tot)


def leaf_specs(params, pspecs) -> list:
    """The partition spec of each leaf of ``params``, in leaf order (the
    spec tree is read by the parameters' keys)."""
    out = []
    tree_map(lambda p, s: out.append(tuple(s)), params, pspecs)
    return out


def value_and_grad(api, params, batch, ctx=None):
    """(loss, gradients in the parameters' dtypes) of ``api.train_loss``
    at ``params``; the gradients are taken with respect to detached
    copies that share the parameters' storage."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = api.train_loss(leaves, batch, ctx)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _slices(batch, m: int):
    """The m equal slices of a batch along its first axis."""
    return [{k: v[i * (v.shape[0] // m):(i + 1) * (v.shape[0] // m)]
             for k, v in batch.items()} for i in range(m)]


def zero_dims(pspecs, accum_pspecs) -> list:
    """Per parameter leaf (in leaf order), the dimension its ``accum_
    pspecs`` entry splits over "data" where its own spec does not; None
    where the two agree."""
    out = []

    def one(ps, acc):
        ps, acc = tuple(ps), tuple(acc)
        dims = [d for d, e in enumerate(acc)
                if e is not None and "data" in ((e,) if isinstance(e, str)
                                                else e)
                and "data" not in spec_axes(ps[d:d + 1])]
        out.append(dims[0] if dims else None)

    _map_specs(one, pspecs, accum_pspecs)
    return out


def zero_blocks(params, pspecs, accum_pspecs, layout):
    """This rank's block of each parameter leaf along its ZeRO dimension
    (``zero_dims``; rank k of the n data ranks: rows [k L / n, (k + 1) L
    / n)), a contiguous copy, the leaf itself where there is none: what
    the ZeRO-2 step's optimizer state is made from (``opt.init``)."""
    dims = iter(zero_dims(pspecs, accum_pspecs))
    n = 1 if layout is None or "data" not in layout.axes else \
        layout.size("data")
    k = 0 if n == 1 else layout.index("data")

    def cut(p):
        d = next(dims)
        if d is None or n == 1:
            return p
        step = p.shape[d] // n
        return p.narrow(d, k * step, step).contiguous()

    return tree_map(cut, params)


def zero_update(opt: AdamW, grads, opt_state, params, pspecs, accum_pspecs,
                layout):
    """The ZeRO-2 step's update: ``opt.update_`` on this rank's blocks
    (``zero_blocks``) with the gradient blocks ``grads``, then each
    parameter all-gathered back over the data ranks, in place. Returns
    (params, new optimizer state)."""
    blocks = zero_blocks(params, pspecs, accum_pspecs, layout)
    _, new_opt = opt.update_(grads, opt_state, blocks)
    group = (layout.group("data") if layout is not None
             and "data" in layout.axes else None)
    for p, blk, d in zip(tree_leaves(params), tree_leaves(blocks),
                         zero_dims(pspecs, accum_pspecs)):
        if d is not None and blk is not p:
            p.copy_(all_gather_dim(blk, group, d))
    return params, new_opt


def make_train_step(api, opt: AdamW, *, microbatch: int = 1,
                    grad_compression: Optional[str] = None,
                    grad_sync: str = "per_microbatch", layout=None,
                    accum_pspecs=None):
    """One training step of ``api`` under ``opt``, data-parallel over
    ``layout``'s data axes when one is given (see the module docstring).
    The parameters and the optimizer state are updated in place
    (``AdamW.update_``, as the reference donates them) and returned.
    ``step.grads(params, batch)`` is the step's (loss, synced gradients)
    without the update. With ``accum_pspecs`` the step is ZeRO-2's and
    ``opt_state`` must be ``opt.init(zero_blocks(...))``'s."""
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}")
    if grad_compression not in COMPRESSIONS:
        raise ValueError(f"grad_compression must be one of {COMPRESSIONS}")
    if accum_pspecs is not None and (grad_sync != "per_microbatch"
                                     or grad_compression is not None):
        raise ValueError("accum_pspecs takes the per-microbatch sync "
                         "without compression")
    ctx = Ctx(layout)
    pspecs = api.param_pspecs()
    dp = tuple(a for a in ctx.dp if layout is not None and a in layout.axes)
    n_dp = ctx.n_dp
    pod = (grad_compression == "int8_pod" and grad_sync == "per_microbatch"
           and layout is not None and "pod" in layout.axes)

    def sync(grads, over, compress=False):
        """Each leaf summed over the axes of ``over`` it is replicated on
        (through ``int8_all_reduce`` when ``compress``), in place where
        it is not compressed."""
        if not over or layout.size(over) == 1:
            return grads
        specs = leaf_specs(grads, pspecs)
        flat = tree_leaves(grads)
        out = list(flat)
        buckets = {}
        for i, (g, spec) in enumerate(zip(flat, specs)):
            names = tuple(a for a in over if a not in spec_axes(spec))
            if names and layout.size(names) > 1:
                buckets.setdefault(names, []).append(i)
        for names, idx in buckets.items():
            group = layout.group(names)
            if compress:
                for i, g in zip(idx, int8_all_reduce([flat[i] for i in idx],
                                                     group)):
                    out[i] = g
            else:
                for i in idx:
                    all_reduce_(flat[i], group)
        it = iter(out)
        return tree_map(lambda _: next(it), grads)

    def mean_loss(loss, over):
        if not over or layout.size(over) == 1:
            return loss
        return all_reduce_(loss.reshape(1).clone(),
                           layout.group(over))[0] / layout.size(over)

    def accumulate(params, slices, over, f32):
        """(mean loss, summed gradients) over ``slices``: each slice's
        gradients summed over ``over``, then added up in float32 (past one
        slice, or always with ``f32``)."""
        if len(slices) == 1 and not f32:
            loss, g = value_and_grad(api, params, slices[0], ctx)
            return loss, sync(g, over)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        ltot = None
        for sl in slices:
            loss, g = value_and_grad(api, params, sl, ctx)
            g = sync(g, over)
            tree_map(lambda a, gg: a.add_(gg.to(torch.float32)), acc, g)
            del g
            ltot = loss if ltot is None else ltot + loss
        return ltot / len(slices), acc

    def scaled(g, n):
        return g if n == 1 else tree_map(lambda t: t.div_(n), g)

    def grads_of(params, batch):
        if grad_sync == "deferred":
            loss, g = accumulate(params, _slices(ctx.rows(batch), microbatch),
                                 (), True)
            # the one sync over the data ranks a step
            g = sync(g, dp, compress=grad_compression == "int8")
            return mean_loss(loss, dp), scaled(g, microbatch * n_dp)
        slices = [ctx.rows(sl) for sl in _slices(batch, microbatch)]
        if pod:
            inner = tuple(a for a in dp if a != "pod")
            loss, g = accumulate(params, slices, inner, False)
            g = scaled(g, microbatch * layout.size(inner))
            g = sync(g, ("pod",), compress=True)
            return mean_loss(mean_loss(loss, inner), ("pod",)), g
        loss, g = accumulate(params, slices, dp, False)
        return mean_loss(loss, dp), scaled(g, microbatch * n_dp)

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        gnorm = grad_norm(grads, leaf_specs(grads, pspecs), layout)
        new_params, new_opt = opt.update_(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    if accum_pspecs is None:
        step.grads = grads_of
        return step

    zdims = zero_dims(pspecs, accum_pspecs)
    data = layout is not None and "data" in layout.axes
    data_group = layout.group("data") if data else None

    def grads_zero(params, batch):
        """(mean loss, float32 gradient blocks in leaf order): each
        slice's gradients reduce-scattered over "data" into the blocks,
        or synced whole (``sync``) where a leaf has no ZeRO dimension."""
        specs = leaf_specs(params, pspecs)
        acc, ltot = None, None
        for sl in _slices(batch, microbatch):
            loss, g = value_and_grad(api, params, ctx.rows(sl), ctx)
            parts = []
            for t, spec, d in zip(tree_leaves(g), specs, zdims):
                if d is None:
                    names = tuple(a for a in dp if a not in spec_axes(spec))
                    if names and layout.size(names) > 1:
                        all_reduce_(t, layout.group(names))
                    parts.append(t)
                    continue
                blk = reduce_scatter_dim(t, data_group, d)
                rest = tuple(a for a in dp if a != "data"
                             and a not in spec_axes(spec))
                if rest and layout.size(rest) > 1:
                    all_reduce_(blk, layout.group(rest))
                parts.append(blk)
            del g
            if acc is None:
                acc = [torch.zeros(t.shape, dtype=torch.float32,
                                   device=t.device) for t in parts]
            for a, t in zip(acc, parts):
                a.add_(t.to(torch.float32))
            ltot = loss if ltot is None else ltot + loss
        for a in acc:
            a.div_(microbatch * n_dp)
        return mean_loss(ltot / microbatch, dp), acc

    def step_zero(params, opt_state, batch):
        loss, acc = grads_zero(params, batch)
        it = iter(acc)
        grads = tree_map(lambda _: next(it), params)
        gnorm = grad_norm(grads, leaf_specs(grads, accum_pspecs), layout)
        _, new_opt = zero_update(opt, grads, opt_state, params, pspecs,
                                 accum_pspecs, layout)
        return params, new_opt, {"loss": loss, "grad_norm": gnorm}

    step_zero.grads = grads_zero
    return step_zero


def make_serve_step(api, layout=None):
    """One greedy decode step: (params, cache, token, pos) -> (next token
    (B, 1), cache). The argmax takes the first index among equal logits.
    Under ``layout`` the parameters and the cache are this rank's blocks
    (``init_params(..., layout=)``, ``init_cache(..., layout=)``), the
    token the global batch, and every rank gets every next token."""
    ctx = None if layout is None else Ctx(layout)

    def step(params, cache, token, pos):
        with torch.inference_mode():
            logits, new_cache = api.decode_step(params, cache, token, pos,
                                                ctx)
            return torch.argmax(logits, dim=-1)[:, None], new_cache

    return step


def make_prefill(api, S_cache: int, layout=None):
    """(params, batch) -> (last hidden, cache); under ``layout`` the cache
    is this rank's block (``launch.shapes.cache_pspecs``)."""
    ctx = None if layout is None else Ctx(layout)

    def prefill(params, batch):
        with torch.inference_mode():
            return api.prefill(params, batch, S_cache, ctx)

    return prefill
