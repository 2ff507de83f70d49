"""AdamW, in-house: the counterpart of ``repro.train.optimizer.AdamW``.

The soft barycenter (``cluster.barycenter``) fits its centroid with this
optimizer, so the port's steps are the reference's: defaults b1 0.9,
b2 0.95, eps 1e-8, bias correction by 1 - b^step in float32, and the
decoupled weight decay applied to the float32 master copy,

    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    master -= lr * (m_hat / (sqrt(v_hat) + eps) + weight_decay * master).

``torch.optim.AdamW`` forms the step as lr / bc1 * m / (sqrt(v) /
sqrt(bc2) + eps), which rounds differently, so it is not used. The
parameters are one tensor; ``update`` is functional (it returns the new
parameters and a new state). The reference's pytrees, moment dtypes,
sharding specs (``state_pspecs``) and LR schedules (``cosine_schedule``)
serve only its LM trainer and belong to the LM slice; they are not here.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: int
    m: torch.Tensor
    v: torch.Tensor
    master: torch.Tensor       # float32 master copy of the parameters


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW with the reference's defaults and rounding."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: torch.Tensor) -> AdamState:
        """Zero moments and the float32 master copy of ``params``."""
        zeros = torch.zeros(params.shape, dtype=torch.float32,
                            device=params.device)
        return AdamState(0, zeros, zeros.clone(),
                         params.detach().to(torch.float32).clone())

    def update(self, grads: torch.Tensor, state: AdamState,
               params: torch.Tensor) -> tuple:
        """One step: (new params, new state)."""
        step = state.step + 1
        dev = grads.device

        def bias(b):
            return 1.0 - torch.tensor(b, dtype=torch.float32, device=dev) \
                ** torch.tensor(float(step), dtype=torch.float32, device=dev)

        g = grads.to(torch.float32)
        m = self.b1 * state.m + (1 - self.b1) * g
        v = self.b2 * state.v + (1 - self.b2) * g * g
        mh = m / bias(self.b1)
        vh = v / bias(self.b2)
        master = state.master - self.lr * (mh / (torch.sqrt(vh) + self.eps)
                                           + self.weight_decay * state.master)
        return master.to(params.dtype), AdamState(step, m, v, master)
