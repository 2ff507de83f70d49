"""What a traced step costs, and the least time it could take: the
counterpart of ``repro.launch.hlo_analysis``.

The reference reads XLA's ``cost_analysis()`` and parses the compiled
HLO's collectives. The port has no HLO; the dry run (``launch/dryrun.py``)
traces its own step under ``FakeTensorMode`` and counts as the ops are
dispatched:

- FLOPs with ``torch.utils.flop_counter.FlopCounterMode`` (the products:
  matmuls, einsums, attention);
- bytes with ``BytesCounter``: the sum of every dispatched op's input and
  output bytes. That is an unfused upper bound, the traffic if every op
  read its inputs from memory and wrote its outputs back. It is not
  XLA's post-fusion "bytes accessed", which counts a fused kernel once;
- collectives with ``CollectiveCounter``: every ``c10d`` op of the
  trace (all-gather, the list form of ``mesh.all_gather_dim`` included,
  all-reduce, reduce-scatter, all-to-all), its group's size read from its
  process group, priced with the reference's per-device ring model:

    all-gather:      out_bytes * (g-1)/g   (receives all but its shard)
    reduce-scatter:  in_bytes  * (g-1)/g
    all-reduce:      2 * out_bytes * (g-1)/g   (RS + AG)
    all-to-all:      out_bytes * (g-1)/g

``roofline_terms`` turns them into times at the NVIDIA H100 SXM5 80 GB's
data-sheet rates (700 W): 989e12 bf16 dense FLOP/s and 3.35e12 B/s of
HBM3. A collective whose group lies within one 8-card node (ranks 8k ..
8k + 7) moves at 450e9 B/s a direction (NVLink 4); one that crosses
nodes at 50e9 B/s (one 400 Gb/s NIC a card). These are predictions from
the data sheet, not measurements.

The kernels' work formulas (the operations a needed DP cell of K1-K9
costs, ``chip_smoke.py``'s bounds) live here too, so the kernel table's
bounds and the Gram and cluster dry runs count the same work.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM5 80 GB (700 W), data sheet: dense bf16 tensor-core
# FLOP/s, and HBM3 bandwidth
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# H100 SXM5: NVLink 4 (900 GB/s both directions) within an 8-card node;
# one ConnectX-7 400 Gb/s NIC per card across nodes
NVLINK_BW = 450e9
NIC_BW = 50e9
NODE = 8
# H100 SXM5, data sheet: FP32 outside the tensor cores
FP32_PEAK = 67e12
# special-function unit (expf's ex2): 16 results per clock per SM on
# compute capability 9.0 (CUDA C Programming Guide, arithmetic
# instruction throughput), 132 SMs at the H100 SXM's 1.98 GHz boost clock
SFU_RATE = 16 * 132 * 1.98e9


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_bytes_dev: float) -> Roofline:
    """The three least times of one device's work (every input per
    device), the collective bytes all over a NIC (the slower link;
    ``CollectiveCounter.seconds`` prices each group at its own)."""
    return Roofline(
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll_bytes_dev / NIC_BW,
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        coll_bytes_per_device=coll_bytes_dev)


def link_bw(ranks) -> float:
    """The per-direction rate of a group of default-group ranks: NVLink
    when they share one node of ``NODE`` cards, else the NIC."""
    nodes = {int(r) // NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NIC_BW


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class BytesCounter(TorchDispatchMode):
    """The sum of every dispatched op's input and output tensor bytes (an
    unfused upper bound on the traffic; views and metadata ops count
    too, as an unfused op would move them)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace != "prim":
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out


# the c10d ops of ``torch.distributed``'s collectives, by the reference's
# names: (name, the argument whose tensors carry the bytes, wire factor
# of (g-1)/g)
_C10D = {
    "allreduce_": ("all-reduce", 0, 2.0),
    "allgather_": ("all-gather", 0, 1.0),
    "_allgather_base_": ("all-gather", 0, 1.0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1.0),
    "reduce_scatter_": ("reduce-scatter", 1, 1.0),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 1.0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 1.0),
    "alltoall_base_": ("all-to-all", 0, 1.0),
    "alltoall_": ("all-to-all", 0, 1.0),
}


def _group_of(args):
    """The process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.distributed.ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject):
            try:
                return torch.distributed.ProcessGroup.unbox(a)
            except (AttributeError, RuntimeError):
                continue
    return None


class CollectiveCounter(TorchDispatchMode):
    """The collectives of a traced step, priced per device (the
    reference's ``parse_collectives``): ``summary()`` is {"per_op": {op:
    {count, result_bytes, wire_bytes}}, "wire_bytes_per_device"}, and
    ``seconds`` each op's wire bytes over its group's link (``link_bw``).
    A group of one moves nothing and is not counted."""

    def __init__(self):
        super().__init__()
        self.per_op = defaultdict(lambda: {"count": 0, "result_bytes": 0,
                                           "wire_bytes": 0.0})
        self.seconds = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d" and func._opname in _C10D:
            self.record(func._opname, args)
        return out

    def record(self, opname, args):
        name, arg, factor = _C10D[opname]
        group = _group_of(args)
        g = (torch.distributed.get_world_size(group) if group is not None
             else torch.distributed.get_world_size())
        if g <= 1:
            return
        size = sum(_nbytes(t) for t in _tensors(args[arg]))
        wire = factor * size * (g - 1) / g
        d = self.per_op[name]
        d["count"] += 1
        d["result_bytes"] += size
        d["wire_bytes"] += wire
        ranks = (torch.distributed.get_process_group_ranks(group)
                 if group is not None else range(g))
        self.seconds += wire / link_bw(ranks)

    def summary(self) -> Dict:
        per_op = {k: dict(v) for k, v in self.per_op.items()}
        return {"per_op": per_op,
                "wire_bytes_per_device": sum(v["wire_bytes"]
                                             for v in per_op.values())}


# ------------------------------------------------- the kernels' work
def bound_cells(cells, flops, sfu, in_bytes, out_bytes):
    """Least time (ms) for ``cells`` needed DP cells of ``flops`` FP32
    operations and ``sfu`` special-function results each, against the
    bytes read and written once; and what bounds it."""
    t_ops = max(cells * flops / FP32_PEAK, cells * sfu / SFU_RATE)
    t_bytes = (in_bytes + out_bytes) / HBM_BW
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


# per needed cell of log K_rdtw: kappa (sub, mul, mul by -nu), K1 (2 add,
# 2 mul), K2 (3 add, 5 mul), the rescale (4 mul) = 19 FP32 operations
# and one expf
KRDTW_FLOPS = 19
# per pair and diagonal k = 1 .. 2T-2, whatever the support: the rescale's
# logf and division, 2 special-function results (lg2, rcp) and 2 FP32
# operations (the log's scale multiply, the running sum's add)
KRDTW_DIAG_SFU, KRDTW_DIAG_FLOPS = 2, 2


def krdtw_bound(pairs, T, cells, in_bytes, out_bytes):
    """Least time (ms) of ``pairs`` log K_rdtw sweeps of ``cells``
    admissible cells each over series of length T: the cells' operations
    and expf, and the (2T - 2) per-diagonal rescales of every pair."""
    diags = pairs * (2 * T - 2)
    t_ops = max((pairs * cells * KRDTW_FLOPS + diags * KRDTW_DIAG_FLOPS)
                / FP32_PEAK,
                (pairs * cells + diags * KRDTW_DIAG_SFU) / SFU_RATE)
    t_bytes = (in_bytes + out_bytes) / HBM_BW
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def admissible_cells(T, radius=None, support=None):
    """Cells of the T x T grid inside the corridor and the support."""
    i = np.arange(T)
    ok = np.ones((T, T), bool) if support is None else np.asarray(support)
    if radius is not None:
        ok = ok & (np.abs(i[:, None] - i[None, :]) <= radius)
    return int(ok.sum())


# per needed cell of DTW: d sub, d mul, d - 1 add, then 2 min and 1 add
def dtw_flops(d):
    return 3 * d + 2


# per needed cell of SP-DTW: DTW's, and 1 weight multiply
def spdtw_flops(d):
    return 3 * d + 3


# per needed cell of the soft forward: the logit (3d + 1: d sub, d mul,
# d - 1 add, the weight and the -1/gamma multiplies), the top / top-left
# logaddexp and the in-row one (sub, max, abs, add each) with their two
# adds, = 3d + 11 FP32 operations; and an expf and a log1pf per
# logaddexp: 4 special-function results
def soft_fwd_flops(d):
    return 3 * d + 11


SOFT_FWD_SFU = 4
# per needed cell of the reverse sweep: three transition coefficients
# (add, sub, two clamps, three compares; an expf each), f = a E + c E' + inj
# (4), the in-row recurrence (2), the logit (3d + 2) and the cotangent
# terms (E w, E phi gbar, 2d for the row and column sums)
SOFT_BWD_SFU = 3


def soft_bwd_flops(d):
    return 5 * d + 29
