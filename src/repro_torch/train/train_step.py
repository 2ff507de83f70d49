"""Train- and serve-step factories (the port of
``repro.train.train_step``, one device).

``make_train_step`` returns ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss's gradients by autograd, then one AdamW
step. With ``microbatch`` m > 1 the batch is cut into m slices along its
first axis, each slice's gradients are summed into float32 buffers and
divided by m (the reference's ``lax.scan`` with float32 accumulators), as
is the loss. Metrics are the loss and the gradients' float32 global
norm. The multi-rank options (``grad_compression``, ``grad_sync=
"deferred"``) belong to the multi-rank LM pieces and raise here.

``make_serve_step`` and ``make_prefill`` run under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.pytree import tree_leaves, tree_map

from .optimizer import AdamW, BLOCK


def grad_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient entry squared, in float32 (a
    block of ``BLOCK`` entries at a time)."""
    tot = None
    for g in tree_leaves(grads):
        flat = g.reshape(-1)
        for i in range(0, flat.numel(), BLOCK):
            part = torch.sum(flat[i:i + BLOCK].to(torch.float32) ** 2)
            tot = part if tot is None else tot + part
    return torch.sqrt(tot)


def value_and_grad(api, params, batch):
    """(loss, gradients in the parameters' dtypes) of ``api.train_loss``
    at ``params``; the gradients are taken with respect to detached
    copies that share the parameters' storage."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = api.train_loss(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(api, opt: AdamW, *, microbatch: int = 1,
                    grad_compression: Optional[str] = None,
                    grad_sync: str = "per_microbatch"):
    """One training step of ``api`` under ``opt``. The parameters and the
    optimizer state are updated in place (``AdamW.update_``, as the
    reference donates them) and returned."""
    if grad_compression is not None or grad_sync != "per_microbatch":
        raise NotImplementedError(
            "grad_compression and grad_sync='deferred' sync gradients "
            "across ranks: the multi-rank LM pieces (ROADMAP A4c)")
    if microbatch < 1:
        raise ValueError(f"microbatch must be >= 1, got {microbatch}")

    def grads_of(params, batch):
        if microbatch == 1:
            return value_and_grad(api, params, batch)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        ltot = None
        for i in range(microbatch):
            sl = {k: v[i * (v.shape[0] // microbatch):
                       (i + 1) * (v.shape[0] // microbatch)]
                  for k, v in batch.items()}
            loss, g = value_and_grad(api, params, sl)
            tree_map(lambda a, gg: a.add_(gg.to(torch.float32)), acc, g)
            del g
            ltot = loss if ltot is None else ltot + loss
        return ltot / microbatch, tree_map(lambda a: a.div_(microbatch), acc)

    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        gnorm = grad_norm(grads)
        new_params, new_opt = opt.update_(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}

    return step


def make_serve_step(api):
    """One greedy decode step: (params, cache, token, pos) -> (next token
    (B, 1), cache). The argmax takes the first index among equal logits."""

    def step(params, cache, token, pos):
        with torch.inference_mode():
            logits, new_cache = api.decode_step(params, cache, token, pos)
            return torch.argmax(logits, dim=-1)[:, None], new_cache

    return step


def make_prefill(api, S_cache: int):
    """(params, batch) -> (last hidden, cache)."""

    def prefill(params, batch):
        with torch.inference_mode():
            return api.prefill(params, batch, S_cache)

    return prefill
