"""AdamW, in-house: the counterpart of ``repro.train.optimizer``.

The LM trainer and the soft barycenter (``cluster.barycenter``) both step
with it, so the port's steps are the reference's: defaults b1 0.9, b2
0.95, eps 1e-8, weight decay 0.1, bias correction by 1 - b^step in
float32, and the decoupled weight decay applied to the float32 master
copy, in this rounding order:

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2   (float32)
    master -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * master)
    param = master cast to the parameter's dtype

``torch.optim.AdamW`` forms the step as lr / bc1 * m / (sqrt(v) /
sqrt(bc2) + eps), which rounds differently, so it is not used.

The parameters are a pytree (dicts and lists of tensors) or one tensor.
``lr`` is a float or a callable of the step (``cosine_schedule``);
``moment_dtype`` stores m and v in float32 or bfloat16; without
``keep_master`` the master is the parameters cast to float32 each step.
``update`` returns new tensors; ``update_`` writes the new values into
the tensors it is given (the reference's donated buffers), so a model
that fills most of the card can step. Both work through each leaf in
blocks of ``BLOCK`` elements, so no float32 temporary is larger than one
block.

Under a rank layout each rank's parameters are its own blocks
(``lm.init_params(..., layout=)``), so ``init`` makes each leaf's state
where the leaf lives: an expert's m, v and master exist only on the rank
that owns the expert, as the reference's ``init`` of sharded parameters
places them. ``state_pspecs`` gives the state's partition specs as
tuples, with the reference's ZeRO-1 rule; the state split over "data"
where the parameter is not runs in ``make_train_step(...,
accum_pspecs=)`` (ZeRO-2), whose state is ``init`` of the rank's blocks
(``train_step.zero_blocks``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.launch.mesh import spec_axes
from repro_torch.pytree import tree_leaves, tree_map

# elements of a leaf updated at once (64 MiB a float32 temporary)
BLOCK = 1 << 24


class AdamState(NamedTuple):
    step: int
    m: Any
    v: Any
    master: Any            # float32 master params, or None (keep_master off)


def _flat(t: torch.Tensor) -> torch.Tensor:
    if not t.is_contiguous():
        raise ValueError("AdamW needs contiguous leaves")
    return t.view(-1)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with the reference's defaults and rounding."""
    lr: Union[Callable[[int], Any], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    keep_master: bool = True

    def init(self, params) -> AdamState:
        """Zero moments and, with ``keep_master``, the float32 master copy
        of ``params``."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)

        master = (tree_map(lambda p: p.detach().to(torch.float32).clone(),
                           params) if self.keep_master else None)
        return AdamState(0, tree_map(zeros, params),
                         tree_map(zeros, params), master)

    def _scalars(self, step: int, device):
        """(lr, 1 - b1^step, 1 - b2^step) as float32 scalars (the lr a
        0-d tensor where ``lr`` is a schedule, else the float)."""
        lr = self.lr(step) if callable(self.lr) else self.lr
        if isinstance(lr, torch.Tensor):
            lr = lr.to(device)
        s = _f32(float(step), device)
        return (lr, 1.0 - _f32(self.b1, device) ** s,
                1.0 - _f32(self.b2, device) ** s)

    def _leaf(self, g, m, v, mast, p, out, lr, b1c, b2c):
        """One leaf through the update, a block at a time; the new m, v,
        master (None without ``keep_master``) and parameter go into
        ``out``'s tensors."""
        om, ov, omast, op = (None if t is None else _flat(t) for t in out)
        g, m, v, p = _flat(g), _flat(m), _flat(v), _flat(p)
        mast = None if mast is None else _flat(mast)
        for i in range(0, g.numel(), BLOCK):
            sl = slice(i, i + BLOCK)
            gf = g[sl].to(torch.float32)
            mf = m[sl].to(torch.float32)
            vf = v[sl].to(torch.float32)
            mf = self.b1 * mf + (1 - self.b1) * gf
            vf = self.b2 * vf + (1 - self.b2) * gf * gf
            mh = mf / b1c
            vh = vf / b2c
            ma = mast[sl] if mast is not None else p[sl].to(torch.float32)
            new = ma - lr * (mh / (torch.sqrt(vh) + self.eps)
                             + self.weight_decay * ma)
            om[sl].copy_(mf)
            ov[sl].copy_(vf)
            if omast is not None:
                omast[sl].copy_(new)
            op[sl].copy_(new)

    def _apply(self, grads, state: AdamState, params, fresh: bool):
        step = state.step + 1
        leaves = tree_leaves(params)
        if not leaves:
            return params, state._replace(step=step)
        lr, b1c, b2c = self._scalars(step, leaves[0].device)

        def one(g, m, v, p, mast=None):
            out = ((torch.empty_like(m), torch.empty_like(v),
                    None if mast is None else torch.empty_like(mast),
                    torch.empty_like(p)) if fresh else (m, v, mast, p))
            self._leaf(g, m, v, mast, p, out, lr, b1c, b2c)
            return out

        outs = tree_map(one, grads, state.m, state.v, params,
                        *((state.master,) if self.keep_master else ()))

        m, v, master, new_params = (_pick_tree(outs, i) for i in range(4))
        return new_params, AdamState(
            step, m, v, master if self.keep_master else None)

    def update(self, grads, state: AdamState, params) -> tuple:
        """One step: (new params, new state), every tensor new."""
        return self._apply(grads, state, params, fresh=True)

    def update_(self, grads, state: AdamState, params) -> tuple:
        """One step written into ``params`` and ``state``'s tensors in
        place; returns them, the state with its step advanced."""
        return self._apply(grads, state, params, fresh=False)

    def state_pspecs(self, param_pspecs, zero1: bool = False,
                     shapes=None, data_size: int = 16) -> AdamState:
        """The optimizer state's partition specs (tuples) for parameters
        placed by ``param_pspecs``: the step replicated, m, v and master
        as their parameter. With ``zero1`` every state leaf not yet split
        over "data" is split over it along its largest still-unsplit
        dimension of ``shapes`` (a pytree of shapes, or of anything with
        ``.shape``) that ``data_size`` divides (the first such on ties);
        a leaf with none stays as it is."""
        def z1(ps, shp):
            ps = tuple(ps)
            used = set(spec_axes(ps))
            if "data" in used:
                return ps
            dims = list(ps) + [None] * (len(shp) - len(ps))
            best, best_sz = -1, 0
            for i, (axes, sz) in enumerate(zip(dims, shp)):
                if axes is None and sz % data_size == 0 and sz > best_sz:
                    best, best_sz = i, sz
            if best < 0:
                return ps
            dims[best] = "data"
            return tuple(dims)

        if zero1:
            if shapes is None:
                raise ValueError("zero1 needs the parameters' shapes")
            mv = _map_specs(lambda ps, s: z1(ps, tuple(getattr(s, "shape",
                                                               s))),
                            param_pspecs, shapes)
        else:
            mv = _map_specs(lambda ps, s: tuple(ps), param_pspecs, None)
        return AdamState((), mv, mv, mv if self.keep_master else None)


def _map_specs(fn, specs, shapes):
    """``fn(spec, shape)`` over a pytree of partition-spec tuples (dicts
    and lists; a tuple is one spec), with the matching leaf of ``shapes``
    (None where there are no shapes)."""
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, None if shapes is None else shapes[k])
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [_map_specs(fn, v, None if shapes is None else shapes[i])
                for i, v in enumerate(specs)]
    return fn(specs, shapes)


def _pick_tree(outs, i):
    """Field ``i`` of every leaf's (m, v, master, param) 4-tuple in a
    pytree of dicts and lists (one tensor's: the 4-tuple itself)."""
    if isinstance(outs, dict):
        return {k: _pick_tree(v, i) for k, v in outs.items()}
    if isinstance(outs, list):
        return [_pick_tree(v, i) for v in outs]
    return outs[i]


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up over ``warmup`` steps, then a cosine decay to 0 at
    ``total``: ``lr(step)`` a float32 0-d tensor (on the CPU), the
    reference's formula in float32."""
    def lr(step):
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = base_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return lr
