"""Mamba-1 selective SSM block (falcon-mamba / jamba mixers; the port of
``repro.models.mamba``).

The selective scan h_t = Abar_t h_{t-1} + Bbar_t x_t is evaluated in
chunks: inside a chunk an associative scan in the reference's own
association (``associative_scan``, the recursive odd / even scheme of
``jax.lax.associative_scan``; a sequential loop would round differently),
and across chunks a loop carrying h. The chunks go through the scan a
block at a time (``SCAN_BLOCK`` elements of the (B, S, d_inner, d_state)
discretized tensors), each chunk's association unchanged: fewer, larger
ops than one chunk at a time, the same values, and the discretized
tensors never whole.

Over the model ranks (``tp_group``, the model axis's group) d_inner is
split: ``in_x``, ``in_z``, the conv, ``dt_up``, ``dt_bias``, ``A_log``
and ``D`` hold this rank's block, so the conv and the scan are local;
``w_B``, ``w_C`` and ``dt_down`` are row-split, so their products are
summed over the ranks and enter the split scan again through
``copy_to``, and ``out``'s product is summed into the replicated
output.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import copy_to, reduce_from
from .layers import FLAGS

# elements of one block of the scan's (B, chunk, d_inner, d_state) float32
# tensors: the chunks of a block go through the associative scan at once
SCAN_BLOCK = 1 << 24


def _ssm_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _interleave(a, b, axis):
    """Elements of ``a`` at the even positions of ``axis``, ``b``'s at the
    odd ones (len(a) == len(b) or len(b) + 1)."""
    n = a.shape[axis] + b.shape[axis]
    shape = list(a.shape)
    shape[axis] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[axis] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[axis] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn, elems, axis: int):
    """Inclusive scan of the tuple ``elems`` along ``axis`` with the
    associative ``fn(earlier, later)``, combining in the same order as
    ``jax.lax.associative_scan``."""
    def sl(x, start, stop=None, step=1):
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]

    def scan(elems):
        n = elems[0].shape[axis]
        if n < 2:
            return elems
        reduced = fn(tuple(sl(e, 0, -1, 2) for e in elems),
                     tuple(sl(e, 1, None, 2) for e in elems))
        odd = scan(reduced)
        if n % 2 == 0:
            even = fn(tuple(sl(e, 0, -1) for e in odd),
                      tuple(sl(e, 2, None, 2) for e in elems))
        else:
            even = fn(tuple(odd), tuple(sl(e, 2, None, 2) for e in elems))
        even = tuple(torch.cat([sl(e, 0, 1), r], dim=axis)
                     for e, r in zip(elems, even))
        return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))

    return scan(tuple(elems))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no linear threshold, in
    x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv1d_causal(x, w, b, state=None):
    """Depthwise causal conv, a sum over the taps in x's dtype.
    x: (B, S, di); w: (dc, di); b: (di,).

    state: optional (B, dc-1, di) left context (decode); returns y and the
    new state (the last dc-1 inputs).
    """
    dc = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, k:k + x.shape[1], :] * w[k] for k in range(dc))
    new_state = xp[:, -(dc - 1):, :]
    return y + b, new_state


def mamba_mixer(x: torch.Tensor, p: dict, *, d_state: int,
                chunk: int | None = None,
                h0: torch.Tensor | None = None,
                conv0: torch.Tensor | None = None,
                return_state: bool = False, tp_group=None):
    """x: (B, S, d) -> (B, S, d). Parameters p:

      in_x (d, di), in_z (d, di), conv_w (dc, di), conv_b (di,),
      w_B (di, ds), w_C (di, ds), dt_down (di, dtr), dt_up (dtr, di),
      dt_bias (di,), A_log (di, ds), D (di,), out (di, d)

    With ``return_state`` also returns (h (B, di, ds) float32, conv state
    (B, dc-1, di)), this rank's block of d_inner under ``tp_group``. The
    scan's chunk is ``chunk``, by default ``layers.FLAGS["mamba_chunk"]``
    (16; decode runs at 1).
    """
    if chunk is None:
        chunk = FLAGS["mamba_chunk"]
    B, S, d = x.shape
    di = p["in_x"].shape[1]

    def summed(t):       # a row-split product, re-entering the split scan
        return copy_to(reduce_from(t, tp_group), tp_group)

    x = copy_to(x, tp_group)
    xs = x @ p["in_x"]                       # (B, S, di)
    z = x @ p["in_z"]
    xs, conv_state = _conv1d_causal(xs, p["conv_w"], p["conv_b"], conv0)
    xs = F.silu(xs)

    Bt = summed(xs @ p["w_B"])               # (B, S, ds)
    Ct = summed(xs @ p["w_C"])
    dt = softplus(summed(xs @ p["dt_down"]) @ p["dt_up"] + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())       # (di, ds)

    ck = chunk if S % chunk == 0 else S
    # chunks scanned at once: as many as keep a (B, ck, di, ds) float32
    # block within SCAN_BLOCK elements
    kb = max(1, min(S // ck, SCAN_BLOCK // (B * ck * di * d_state)))
    h = (x.new_zeros((B, di, d_state), dtype=torch.float32) if h0 is None
         else h0.float())
    ys = []
    for b0 in range(0, S, ck * kb):
        n = min(kb, (S - b0) // ck)

        def chunks(t):       # (B, n * ck, ...) -> (B, n, ck, ...)
            return t[:, b0:b0 + n * ck].reshape((B, n, ck) + t.shape[2:])

        xc, dtf, bc, cc = chunks(xs), chunks(dt).float(), chunks(Bt), \
            chunks(Ct)
        abar = torch.exp(dtf[..., None] * A)               # (B,n,ck,di,ds)
        bbar = (dtf[..., None] * bc[..., None, :].float()
                * xc[..., None].float())
        aa, bb = associative_scan(_ssm_combine, (abar, bbar), axis=2)
        hs = []
        for k in range(n):                 # the carry, chunk after chunk
            hs.append(aa[:, k] * h[:, None] + bb[:, k])    # (B,ck,di,ds)
            h = hs[-1][:, -1]
        ys.append(torch.einsum("bncds,bncs->bncd", torch.stack(hs, 1),
                               cc.float()).reshape(B, n * ck, di))
    y = torch.cat(ys, dim=1)
    y = (y + xs.float() * p["D"]).to(x.dtype)
    out = reduce_from((y * F.silu(z)) @ p["out"], tp_group)
    if return_state:
        return out, (h, conv_state)
    return out


def mamba_decode_step(x: torch.Tensor, p: dict, state, *, d_state: int,
                      tp_group=None):
    """Single-token decode, the mixer at chunk 1. x: (B, 1, d);
    state = (h (B,di,ds), conv (B,dc-1,di)), this rank's block of d_inner
    under ``tp_group``."""
    return mamba_mixer(x, p, d_state=d_state, chunk=1, h0=state[0],
                       conv0=state[1], return_state=True, tp_group=tp_group)


def init_mamba_state(B: int, di: int, d_state: int, d_conv: int, dtype,
                     device=None):
    return (torch.zeros((B, di, d_state), dtype=torch.float32,
                        device=device),
            torch.zeros((B, d_conv - 1, di), dtype=dtype, device=device))
