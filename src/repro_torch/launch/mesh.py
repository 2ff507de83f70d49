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

  python -m torch.distributed.run --standalone --nproc_per_node 2 \\
      -m -- repro_torch.launch.gram --backend gloo --out /tmp/gram
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional, Tuple

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
