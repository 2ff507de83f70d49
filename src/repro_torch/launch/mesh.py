"""Process groups for the multi-device jobs: the counterpart of
``repro.launch.mesh``.

The reference lays its jobs over a jax device mesh (``make_mesh``,
``make_host_mesh``). Here a job is one program per rank under
``torch.distributed``: the launcher (``python -m torch.distributed.run``)
starts the ranks and gives each one ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
in its environment; ``init_group`` joins the default group from them, with
the collective backend the caller names:

  nccl   one card per rank: rank r of a host computes on ``cuda:r`` (the
         current device is set before any kernel launches). More ranks
         on a host than cards raises; the backend is never changed.
  gloo   collectives through the host. Ranks compute on the device the
         caller names (``cuda`` by default: card ``LOCAL_RANK`` modulo the
         card count, so two ranks share one card; ``cpu`` for the plain
         versions).

A program with no group is one rank (``world()`` is (0, 1)), the
counterpart of the reference's 1 x 1 host mesh; its jobs run the same
code with nothing to gather.

``Layout`` is the counterpart of the mesh itself (``make_mesh``;
``make_host_mesh`` builds the (data, model) one, ``make_production_mesh``
the 16 x 16 and 2 x 16 x 16 ones): the default group's ranks laid out
row-major over named axes, as ``jax.make_mesh`` orders its devices, with
one subgroup per slice of every set of axes. The multi-rank LM trainer
places its parameters and batch rows by it. gloo takes CUDA tensors in every
collective the trainer calls (``tools/gloo_cuda_probe.py``: torch 2.11
on an H100), so they are passed as they are, on either backend.

Tensor parallelism (the model axis, Megatron's scheme) crosses its
region boundaries through three autograd functions over the axis's
group: ``copy_to`` (identity forward, gradient all-reduced), where a
replicated activation enters a split product; ``reduce_from``
(all-reduce forward, identity backward), which closes a row-split
product; ``gather_from`` (all-gather forward, the rank's slice
backward). Each is the identity, with no collective, for a group of
one.

  python -m torch.distributed.run --standalone --nproc_per_node 2 \\
      -m -- repro_torch.launch.gram --backend gloo --out /tmp/gram
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def launched() -> bool:
    """True when the launcher started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_device(backend: str, device=None) -> torch.device:
    """The device this rank computes on under ``backend`` (see the module
    docstring); raises where the backend cannot have one."""
    from repro_torch.core.engine import resolve_device
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError("nccl ranks compute on their own card")
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE",
                                      os.environ.get("WORLD_SIZE", 1)))
        if per_host > n_cards:
            raise RuntimeError(
                f"nccl runs one card per rank: {per_host} ranks on this "
                f"host, {n_cards} cards (use gloo to share a card)")
        return torch.device("cuda", local)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def init_group(backend: str, device=None) -> torch.device:
    """Start or join the default process group from the launcher's
    environment and return this rank's device (made current when it is a
    card, so the kernels launch there)."""
    if not launched():
        raise RuntimeError("no launcher environment: start the job with "
                           "python -m torch.distributed.run")
    dev = rank_device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend}")
    return dev


def world() -> Tuple[int, int]:
    """(rank, size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_gather_cat(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
    rank order, on ``t``'s device: ``t`` itself without a group. The list
    form of ``all_gather``; under gloo the tensors travel through the
    host."""
    if not (dist.is_available() and dist.is_initialized()):
        return t
    size = dist.get_world_size()
    src = t.detach().contiguous()
    if dist.get_backend() == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim).to(t.device)


def gather_objects(obj) -> List:
    """Every rank's picklable ``obj``, in rank order (``[obj]`` without a
    group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def report(out: Optional[str], arrays: dict, meta: dict) -> None:
    """Write a job's result under the directory ``out``: ``result.npz``
    with ``arrays`` and ``result.json`` with ``meta``, the group's size
    and each rank's kernel launch counts. Every rank calls it (the counts
    are gathered); rank 0 writes."""
    from repro_torch.kernels import launch_counts
    counts = gather_objects(launch_counts())
    rank, size = world()
    if out is None or rank != 0:
        return
    path = Path(out)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "result.npz", **arrays)
    meta = dict(meta, world_size=size,
                backend=dist.get_backend() if dist.is_initialized()
                else None, launches=counts)
    (path / "result.json").write_text(json.dumps(meta, indent=1,
                                                 default=float) + "\n")


def destroy_group() -> None:
    """Leave the default group, when there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- rank layout
Axes = Union[str, Sequence[str]]


class Layout:
    """The default group's ranks over named axes, row-major: under shape
    (D, M) rank ``d * M + m`` sits at (d, m), as ``jax.make_mesh`` places
    devices. Without a group it is the 1 x ... x 1 layout of rank 0.

    For every non-empty set of axes (in a fixed order) and every slice
    along it (the ranks that share all other coordinates) a subgroup is
    made: ``torch.distributed.new_group`` is collective over the default
    group, so every rank makes every subgroup, in the same order, member
    or not. A slice of one rank has no subgroup (its collectives are the
    identity), and slices with the same members share one.
    """

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        self.shape = tuple(int(n) for n in shape)
        self.axes = tuple(axes)
        if len(self.shape) != len(self.axes) or len(set(self.axes)) != len(
                self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"must pair up, the axes distinct")
        self.rank, size = world()
        if math.prod(self.shape) != size:
            raise ValueError(f"layout {dict(zip(self.axes, self.shape))} "
                             f"needs {math.prod(self.shape)} ranks, the "
                             f"group has {size}")
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.shape))
        self._groups: Dict[Tuple[str, ...], Tuple[Optional[object],
                                                  Tuple[int, ...]]] = {}
        made: Dict[Tuple[int, ...], object] = {}
        for n in range(1, len(self.axes) + 1):
            for names in itertools.combinations(self.axes, n):
                for members in self._slices(names):
                    if len(members) > 1 and members not in made:
                        made[members] = dist.new_group(list(members))
                    if self.rank in members:
                        self._groups[names] = (made.get(members), members)

    def _norm(self, names: Axes) -> Tuple[str, ...]:
        """``names`` as a tuple of this layout's axes in layout order."""
        names = (names,) if isinstance(names, str) else tuple(names)
        unknown = [a for a in names if a not in self.axes]
        if unknown:
            raise KeyError(f"axes {unknown} not in the layout {self.axes}")
        return tuple(a for a in self.axes if a in names)

    def _slices(self, names: Tuple[str, ...]):
        """The rank tuples along ``names``: one per coordinate of the
        other axes, row-major, each sorted (row-major over ``names``)."""
        along = [i for i, a in enumerate(self.axes) if a in names]
        rest = [i for i in range(len(self.axes)) if i not in along]
        for fixed in itertools.product(*(range(self.shape[i])
                                         for i in rest)):
            members = []
            for free in itertools.product(*(range(self.shape[i])
                                            for i in along)):
                c = [0] * len(self.axes)
                for i, v in zip(rest, fixed):
                    c[i] = v
                for i, v in zip(along, free):
                    c[i] = v
                members.append(int(np.ravel_multi_index(c, self.shape)))
            yield tuple(sorted(members))

    def size(self, names: Axes) -> int:
        """Ranks along ``names`` (a product over several axes; 1 for
        none)."""
        names = self._norm(names)
        return math.prod(self.shape[self.axes.index(a)] for a in names)

    def index(self, names: Axes) -> int:
        """This rank's position along ``names``, row-major over them."""
        names = self._norm(names)
        if not names:
            return 0
        idx = [self.axes.index(a) for a in names]
        return int(np.ravel_multi_index([self.coords[i] for i in idx],
                                         [self.shape[i] for i in idx]))

    def group(self, names: Axes):
        """The subgroup of this rank's slice along ``names``; None where
        the slice is this rank alone."""
        names = self._norm(names)
        return self._groups[names][0] if names else None

    def members(self, names: Axes) -> Tuple[int, ...]:
        """The default-group ranks of this rank's slice along ``names``,
        in group order."""
        names = self._norm(names)
        return self._groups[names][1] if names else (self.rank,)

    def __repr__(self):
        return (f"Layout({dict(zip(self.axes, self.shape))}, rank "
                f"{self.rank} at {self.coords})")


def make_host_mesh(data: int = 1, model: int = 1) -> Layout:
    """A (data, model) layout over the group's ranks (the reference's
    ``make_host_mesh``)."""
    return Layout((data, model), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> Layout:
    """The production layout over the default group (the reference's
    ``make_production_mesh``): 16 x 16 ranks over ("data", "model"), or
    2 x 16 x 16 over ("pod", "data", "model") with ``multi_pod``. The
    group must have 256 or 512 ranks: a real job's, or a fake one
    (``fake_world``) for the dry run."""
    if multi_pod:
        return Layout((2, 16, 16), ("pod", "data", "model"))
    return Layout((16, 16), ("data", "model"))


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """This process as rank ``rank`` of a default group of ``n`` ranks that
    exist nowhere: torch's "fake" backend, whose collectives return at
    once and move nothing (the dry run's stand-in for a cluster). The
    group is destroyed on exit, whatever happens inside; a group already
    open raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over ``group`` ("sum" or "max"); the
    identity for a group of one (None)."""
    if group is not None:
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def exchange(t: torch.Tensor, group) -> torch.Tensor:
    """All-to-all along axis 0 over ``group``: ``t`` is (n, ...) for a
    group of n ranks; row j goes to group rank j, and row i of the result
    came from group rank i (the reference's ``lax.all_to_all`` with
    split and concat axis 0, untiled). Its own inverse; the identity for
    a group of one."""
    if group is None:
        return t
    src = t.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every group rank's ``t`` (equal shapes) concatenated along ``dim``
    in group order; ``t`` for a group of one."""
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``t`` (equal shapes) summed, and this rank's block of
    the sum along ``dim`` (rank k of n: rows [k L / n, (k + 1) L / n)),
    contiguous; ``t`` for a group of one. Off dimension 0 the tensor is
    copied to ``dim``-major order and back, size-1 dimensions or not, so
    the work does not depend on them."""
    if group is None:
        return t

    def moved(x, a, b):
        return x if a == b else x.movedim(a, b).clone(
            memory_format=torch.contiguous_format)

    src = moved(t.contiguous(), dim, 0)
    out = src.new_empty((src.shape[0] // dist.get_world_size(group),)
                        + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return moved(out, 0, dim)


# ------------------------------------------- tensor-parallel collectives
# Megatron's three region boundaries as autograd functions over a group
# (the model axis's). Each is the identity, with no autograd node, for a
# group of one (None).

class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: where a replicated
    activation enters a split region, the ranks' partial gradients are
    summed."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward (in the input's dtype), identity backward: a
    row-split product's partial sums closed into the replicated
    activation."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format),
                           group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward, this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` backward."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward, gradient passed backward."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` forward, this rank's
    slice of the gradient backward."""
    return x if group is None else _GatherFrom.apply(x, group, dim)


# -------------------------------------------------- placement by pspec
# A partition spec is a tuple with one entry per dimension: an axis name,
# a tuple of names, or None (the reference's PartitionSpec as a tuple).

def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis name a partition spec uses, in order."""
    out = []
    for entry in spec:
        if entry is None:
            continue
        out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)


def sharded_dims(spec, layout: Optional[Layout]):
    """(dim, axes) for each dimension of ``spec`` that ``layout`` splits
    over more than one rank (axes the layout lacks replicate)."""
    if layout is None:
        return []
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = tuple(a for a in ((entry,) if isinstance(entry, str)
                                  else entry) if a in layout.axes)
        if names and layout.size(names) > 1:
            out.append((dim, names))
    return out


def local_shape(shape, spec, layout: Optional[Layout]) -> Tuple[int, ...]:
    """The shape of this rank's block of a leaf of ``shape`` under
    ``spec`` (raises where a split dimension does not divide)."""
    shape = list(shape)
    for dim, names in sharded_dims(spec, layout):
        n = layout.size(names)
        if shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split over {n} ranks of {names}")
        shape[dim] //= n
    return tuple(shape)


def local_slice(t: torch.Tensor, spec, layout: Optional[Layout]):
    """This rank's block of the whole leaf ``t`` under ``spec``: along each
    split dimension of length L over n ranks, rows [k L / n, (k + 1) L /
    n) for the rank's position k; a contiguous copy where anything is
    cut, ``t`` itself otherwise."""
    dims = sharded_dims(spec, layout)
    for dim, names in dims:
        n, k = layout.size(names), layout.index(names)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                             f"not split over {n} ranks of {names}")
        step = t.shape[dim] // n
        t = t.narrow(dim, k * step, step)
    return t.contiguous().clone() if dims else t


def gather_leaf(t: torch.Tensor, spec, layout: Optional[Layout]):
    """The whole leaf from every rank's block ``t`` under ``spec`` (the
    inverse of ``local_slice``); every rank of each slice calls it."""
    for dim, names in reversed(sharded_dims(spec, layout)):
        t = all_gather_dim(t, layout.group(names), dim)
    return t
