"""The assigned input shapes, the decode caches' partition specs and the
dry run's inputs (the port of ``repro.launch.shapes``).

  train_4k     seq 4096,   batch 256  -> train_step
  prefill_32k  seq 32768,  batch 32   -> prefill
  decode_32k   seq 32768,  batch 128  -> serve_step (cache of seq_len)
  long_500k    seq 524288, batch 1    -> serve_step; only sub-quadratic
                                         architectures run it

``cache_pspecs`` places a decode cache over a rank layout as the
reference places it over its mesh: the sequence over "model"
(flash-decode, whatever the head count), the batch over the data axes
where they divide it, and at batch 1 the sequence (or a Mamba state's
d_inner) over ("data", "model"). ``lm.init_cache`` / ``whisper.
init_cache`` keep each rank's block of it, and ``decode_step`` merges the
ranks' attention over the axes the sequence is split on.

``input_specs`` resolves an (architecture x shape) cell over a rank
layout to a ``Cell``: the inputs the port's step takes, made as empty
tensors on the current device (fake ones under ``FakeTensorMode``, the
dry run's case), with each leaf's global shape, dtype, partition spec and
this rank's block shape (``Cell.leaves``), and the cell's ``seq_len``,
``batch`` and ``tokens_per_step``, as the reference's ``input_specs``
gives them.
Token ids are int64 (torch's index dtype) where the reference's are
int32. The port's entry points take the global batch of tokens, patches
and frames and cut this rank's rows themselves (``lm.Ctx.rows``), so
those arguments are whole; the decode cache is this rank's block
(``init_cache(..., layout=)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig

SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Whether an (architecture x shape) cell runs, and why not."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("skip: pure full-attention arch; long_500k requires "
                       "sub-quadratic attention (DESIGN.md §6)")
    return True, ""


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis: ranks} of a ``launch.mesh.Layout``, or of a mapping given
    as it is (a layout need not exist to compute its specs)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.axes, mesh.shape))


def _dp(sizes) -> tuple:
    return ("pod", "data") if "pod" in sizes else ("data",)


def _entry(names: tuple):
    """A spec entry as the reference's ``PartitionSpec`` keeps it: one
    axis as its name, several as a tuple."""
    return names[0] if len(names) == 1 else names


def cache_pspecs(cfg: ModelConfig, B: int,
                 mesh: Union[Mapping[str, int], object]):
    """The decode cache's partition specs (tuples, leaf for leaf with
    ``init_cache``) at global batch ``B`` over ``mesh`` (a layout or
    {axis: size})."""
    sizes = axis_sizes(mesh)
    dp = _dp(sizes)
    b = (_entry(dp) if B % math.prod(sizes.get(a, 1) for a in dp) == 0
         else None)
    seq = ("data", "model") if B == 1 else "model"
    if cfg.family == "audio":
        return {"self": {"k": (None, b, seq, None, None),
                         "v": (None, b, seq, None, None)},
                "cross": {"k": (None, b, None, "model", None),
                          "v": (None, b, None, "model", None)}}
    specs = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            # a window's ring may not divide (data, model): "model" only
            s = seq if spec.window is None else "model"
            specs.append({"k": (None, b, s, None, None),
                          "v": (None, b, s, None, None)})
        elif spec.mixer == "mla":
            specs.append({"ckv": (None, b, seq, None),
                          "krope": (None, b, seq, None)})
        elif spec.mixer == "mamba":
            di_ax = ("data", "model") if B == 1 else "model"
            specs.append({"h": (None, b, di_ax, None),
                          "conv": (None, b, None, di_ax)})
        else:
            specs.append({})
    return specs


class Leaf(NamedTuple):
    """One input leaf of a cell: its global shape and dtype, its partition
    spec and the shape of this rank's block under it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: tuple
    local: Tuple[int, ...]


@dataclasses.dataclass
class Cell:
    """One (architecture x shape) cell's inputs over a layout: ``args``
    the step's inputs (the batch; or token, cache, pos), ``leaves``
    {path: Leaf} of every tensor in ``args`` ("0/tokens", "1/3/k": keys
    and list positions joined by "/")."""
    kind: str             # train | prefill | decode
    args: tuple
    leaves: Dict[str, Leaf]
    seq_len: int
    batch: int
    tokens_per_step: int


def tree_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf} of a pytree of dicts, lists and tuples, the keys and
    positions joined by "/" (the same paths for the reference's trees)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def input_specs(cfg: ModelConfig, shape: str, layout=None, api=None) -> Cell:
    """The cell's inputs over ``layout`` (a ``launch.mesh.Layout``, None
    for one rank), made on the current device; ``api`` (``models.build
    (cfg)``) is needed for a decode cell's cache."""
    from repro_torch.launch.mesh import local_shape
    S, B, kind = SHAPES[shape]
    sizes = {} if layout is None else axis_sizes(layout)
    dp = _dp(sizes)
    b = (_entry(dp) if B % math.prod(sizes.get(a, 1) for a in dp) == 0
         else None)

    def leaf(shp, dtype, spec):
        return Leaf(tuple(shp), dtype, tuple(spec),
                    local_shape(shp, spec, layout))

    if kind in ("train", "prefill"):
        s_text = S - cfg.n_patches if cfg.family == "vlm" else S
        batch, leaves = {}, {}
        if cfg.family == "vlm":
            batch["patches"] = ((B, cfg.n_patches, cfg.d_model),
                                torch.bfloat16, (b, None, None))
        if cfg.family == "audio":
            batch["frames"] = ((B, cfg.n_frames, cfg.d_model),
                               torch.bfloat16, (b, None, None))
        batch["tokens"] = ((B, s_text + (kind == "train")), torch.long,
                           (b, None))
        for k, (shp, dt, spec) in batch.items():
            leaves[f"0/{k}"] = leaf(shp, dt, spec)
        args = ({k: torch.empty(shp, dtype=dt)
                 for k, (shp, dt, _) in batch.items()},)
        return Cell(kind, args, leaves, S, B, B * S)

    if api is None:
        raise ValueError("a decode cell needs the model's api for its cache")
    whole = tree_paths(api.init_cache(B, S, device="meta"), "1")
    specs = cache_pspecs(cfg, B, sizes)
    cache = api.init_cache(B, S, device=torch.get_default_device(),
                           layout=layout)
    leaves = {"0": leaf((B, 1), torch.long, (b, None))}
    for (path, t), spec in zip(whole.items(), _spec_leaves(specs)):
        leaves[path] = leaf(t.shape, t.dtype, spec)
    leaves["2"] = leaf((), torch.long, ())
    args = (torch.empty((B, 1), dtype=torch.long), cache,
            torch.zeros((), dtype=torch.long))
    return Cell("decode", args, leaves, S, B, B)


def _spec_leaves(specs) -> list:
    """The spec tuples of ``cache_pspecs``, in ``tree_paths`` order."""
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    if isinstance(specs, list):
        return [s for v in specs for s in _spec_leaves(v)]
    return [tuple(specs)]
