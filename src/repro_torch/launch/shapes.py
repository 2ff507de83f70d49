"""The assigned input shapes and the decode caches' partition specs (the
port of ``repro.launch.shapes``; its ``input_specs`` / ``Cell``, the
dry-run's abstract inputs, are not here yet).

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
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple, Union

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
