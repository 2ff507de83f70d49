"""Checkpoints with atomic commits, async writes, keep-last-k and
integrity hashes (the port of ``repro.train.checkpoint``, one device).

Layout, the reference's:  <dir>/step_<n:08d>/
    manifest.json   {"step", "leaves": [{"path", "file", "shape",
                     "dtype", "sha256"} | {"path", "none": true}]}
    leaf_<i:05d>.npy  one file per pytree leaf, in ``_leaf_paths`` order

A bfloat16 leaf is written as its uint16 bits with manifest dtype
"bfloat16", and any leaf whose manifest says "bfloat16" is read back as
those bits (the reference writes such a leaf as two raw bytes), so a
checkpoint of either package restores in the other, bit for bit. An int
leaf (``AdamState.step``) is written as an int32 scalar. Each leaf's file
is hashed (sha256) and checked on restore; a half-written checkpoint is
invisible (a ``.tmp`` directory renamed on commit); ``latest_step`` is the
newest complete one.

Under a rank layout (``launch.mesh.Layout``) with the trees' partition
specs (``specs``, as ``lm.param_pspecs`` and ``AdamW.state_pspecs`` give
them), a save gathers each split leaf whole, one leaf at a time, to rank
0, which alone writes the same format; the other ranks wait for it (the
reference writes ``np.asarray`` of its sharded arrays, ``:65``). A
restore reads whole leaves on every rank and keeps the rank's block (the
reference's ``restore_checkpoint(..., shardings=)``). So a checkpoint
moves between rank counts, and between the two packages, unchanged.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.mesh import gather_leaf, local_slice, world
from repro_torch.pytree import tree_map


def _leaf_paths(tree, prefix=""):
    """Stable (path, leaf) enumeration for dict / list / (named)tuple
    pytrees: dict keys sorted, sequences by index. None nodes are
    recorded (and restored) as None."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


class _HostLeaf:
    """A leaf copied to the host: the array to write and the manifest's
    dtype."""
    __slots__ = ("arr", "dtype")

    def __init__(self, arr: np.ndarray, dtype: str):
        self.arr, self.dtype = arr, dtype


def _to_numpy(leaf) -> _HostLeaf:
    """A tensor, an int or an array as the leaf to write."""
    if isinstance(leaf, torch.Tensor):
        # a copy: the trainer updates its tensors in place while an
        # async save is still writing
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.view(torch.int16).numpy().view(np.uint16),
                             "bfloat16")
        arr = t.numpy()
    elif isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return _HostLeaf(arr, str(arr.dtype))


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write(directory: str, step: int, host_tree) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_leaf_paths(host_tree)):
        if leaf is None:
            manifest["leaves"].append({"path": path, "none": True})
            continue
        arr, dtype = leaf.arr, leaf.dtype
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "path": path, "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "sha256": _sha256(os.path.join(tmp, fname))})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # atomic commit
    return final


def _barrier(layout) -> None:
    if layout is not None and world()[1] > 1:
        torch.distributed.barrier()


def _host_tree(tree, specs, layout):
    """The tree's leaves whole and on the host on rank 0 (None elsewhere):
    each split leaf is gathered from its ranks, one leaf at a time, by
    every rank."""
    if specs is None or layout is None:
        return tree_map(_to_numpy, tree)
    writer = world()[0] == 0

    def one(leaf, spec):
        if isinstance(leaf, torch.Tensor):
            leaf = gather_leaf(leaf, spec, layout)
        return _to_numpy(leaf) if writer else None

    return tree_map(one, tree, specs)


def save_checkpoint(directory: str, step: int, tree: Any, specs=None,
                    layout=None) -> str:
    """Blocking save of a pytree of tensors (and ints). Under ``layout``
    every rank calls it with its blocks and the trees' ``specs``; rank 0
    writes the whole leaves and the others wait. Returns the committed
    path."""
    host = _host_tree(tree, specs, layout)
    final = os.path.join(directory, f"step_{step:08d}")
    if world()[0] == 0 or layout is None:
        final = _write(directory, step, host)
    _barrier(layout)
    return final


def list_checkpoints(directory: str):
    """The steps of the complete checkpoints in ``directory``, sorted."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _from_numpy(arr: np.ndarray, dtype: str, like):
    """One restored leaf shaped like ``like``: an int for an int, else a
    tensor on ``like``'s device (the CPU where ``like`` is no tensor)."""
    if isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def restore_checkpoint(directory: str, step: int, like: Any, specs=None,
                       layout=None) -> Any:
    """Restore into the structure of ``like`` (a pytree of tensors and
    ints; its leaves' values are not read), each tensor on the ``like``
    leaf's device; under ``layout`` each leaf is read whole and cut to
    this rank's block by its entry of ``specs``. Raises ``IOError``
    where a leaf's sha256 does not match the manifest's."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}

    def load(lpath, like_leaf, spec):
        meta = by_path[lpath]
        if meta.get("none"):
            return None
        fpath = os.path.join(path, meta["file"])
        if _sha256(fpath) != meta["sha256"]:
            raise IOError(f"checksum mismatch for {lpath}")
        whole = np.load(fpath)
        if spec is not None and isinstance(like_leaf, torch.Tensor):
            cut = local_slice(_from_numpy(whole, meta["dtype"], None),
                              spec, layout)
            return cut.to(like_leaf.device)
        return _from_numpy(whole, meta["dtype"], like_leaf)

    def rebuild(node, spec, prefix=""):
        if isinstance(node, dict):
            return {k: rebuild(node[k], None if spec is None else spec[k],
                               f"{prefix}.{k}") for k in node}
        if isinstance(node, (list, tuple)):
            out = [rebuild(v, None if spec is None else spec[i],
                           f"{prefix}[{i}]") for i, v in enumerate(node)]
            if isinstance(node, tuple) and hasattr(node, "_fields"):
                return type(node)(*out)
            return type(node)(out)
        return load(prefix, node, spec)

    return rebuild(like, specs if layout is not None else None)


class CheckpointManager:
    """Async writer + retention. ``save`` copies the tree to the host and
    returns; a thread writes it (the previous write is joined first: at
    most one in flight), then deletes all but the newest ``keep_last``.
    Under ``layout`` every rank calls ``save`` (with the trees' specs)
    and ``wait``; rank 0 writes, and ``wait`` holds the other ranks until
    its write is committed."""

    def __init__(self, directory: str, keep_last: int = 3, layout=None):
        self.directory = directory
        self.keep_last = keep_last
        self.layout = layout
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, specs=None):
        self.wait()
        host_tree = _host_tree(tree, specs, self.layout)
        if self.layout is not None and world()[0] != 0:
            return

        def work():
            _write(self.directory, step, host_tree)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.layout)

    def _gc(self):
        steps = list_checkpoints(self.directory)
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = list_checkpoints(self.directory)
        return steps[-1] if steps else None
