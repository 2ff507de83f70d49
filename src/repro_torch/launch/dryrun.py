"""Production dry run on a fake 256- or 512-rank layout: the counterpart
of ``repro.launch.dryrun``.

For every (architecture x input shape x layout) cell the reference
compiles its production step for a fake 16 x 16 (or 2 x 16 x 16) CPU
mesh and reads XLA's memory and cost analyses. Here the port's own
production step is traced, as rank 0 of a default group of 256 or 512
ranks that exist nowhere (``mesh.fake_world``: torch's "fake" backend,
whose collectives move nothing), on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``): every op runs its
shape rule and nothing is computed. The tensors are fake CUDA tensors on
a CUDA build of torch, fake CPU tensors on a CPU build (whose Python
indexing of a CUDA tensor needs a CUDA device guard it lacks); shapes,
dtypes and counts are the same on either. ``tensors="meta"`` (``--meta``)
traces on torch's meta device instead, the shape rules FakeTensorMode
wraps without its bookkeeping: the same counts, in about 40 % of the
time (``tests/test_torch_dryrun.py`` holds the two equal), which the
full sweep on a CPU takes.

  A. ``trace_real_step``: the real step at full depth (train: the
     ZeRO-2 ``make_train_step`` at ``TRAIN_MICROBATCH`` microbatches, 8
     on 2 x 16 x 16 so that each holds a row a data rank
     (``step_microbatch``), the optimizer state placed by
     ``state_pspecs(zero1=True)``; the plain step without a data axis to
     split over; prefill:
     ``make_prefill``; decode: ``make_serve_step`` on this rank's block of
     the cache) under ``torch.distributed._tools.mem_tracker.MemTracker``.
     ``memory.argument_bytes`` is the rank's parameters, optimizer state
     and inputs, ``peak_bytes_est`` MemTracker's peak, ``temp_bytes`` the
     difference; ``fits_80GB`` holds the peak to an H100's 80 GB.

  B. (16 x 16 only) cost probes: the same step at 1 and 2 groups under
     ``FlopCounterMode``, ``cost_analysis.BytesCounter`` and
     ``cost_analysis.CollectiveCounter``, with ``layers.set_probe_mode``
     (the reference's fatter chunks). Groups are homogeneous, so

        total(G) = probe(1) + (G - 1) * (probe(2) - probe(1))

     is the full depth's count; train cells probe one microbatch's
     gradients, scale by the microbatches and add the optimizer update
     at full depth (``_opt_probe``). FlopCounterMode counts every
     iteration of a Python loop, so the probes need no unrolling.

Roofline terms are predictions at the H100 SXM5 data sheet's rates
(``cost_analysis``), not measurements.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
      --shape decode_32k --no-probes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import (fake_world, local_shape,
                                     make_production_mesh)
from repro_torch.launch.shapes import SHAPES, cell_supported, input_specs
from repro_torch.models import build
from repro_torch.models.layers import FLAGS, set_probe_mode
from repro_torch.models.lm import Ctx
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamState, AdamW, _map_specs
from repro_torch.train.train_step import (make_prefill, make_serve_step,
                                          make_train_step, zero_blocks,
                                          zero_update)

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"
TRAIN_MICROBATCH = 16
# an H100's memory
CARD_BYTES = 80e9

# Memory-policy overrides for the very large configs: bf16 Adam moments and
# no float32 master; everything else: float32 + ZeRO-1.
OPT_OVERRIDES = {
    "deepseek-v2-236b": dict(moment_dtype=torch.bfloat16, keep_master=False),
    "jamba-v0.1-52b": dict(moment_dtype=torch.bfloat16, keep_master=False),
}
MESHES = {False: ("16x16", 256), True: ("2x16x16", 512)}


def trace_device() -> torch.device:
    """Where the fake tensors live: ``cuda`` on a CUDA build of torch,
    else ``cpu`` (see the module docstring)."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "cpu")


@contextlib.contextmanager
def fake_tensors(tensors: str = "fake"):
    """Every tensor made inside is a fake one on ``trace_device()``
    (``tensors="fake"``) or a meta tensor (``"meta"``)."""
    if tensors == "meta":
        with torch.device("meta"):
            yield
        return
    if tensors != "fake":
        raise ValueError(f"tensors must be fake or meta, not {tensors!r}")
    with FakeTensorMode(), torch.device(trace_device()):
        yield


def _reduced_depth(cfg, g: int):
    return dataclasses.replace(
        cfg, n_layers=g * len(cfg.pattern),
        n_enc_layers=g if cfg.n_enc_layers else 0)


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def global_shapes(api):
    """The parameters' whole shapes (meta tensors, nothing allocated)."""
    with torch.device("meta"):
        return api.abstract_params()


def opt_setup(api, layout, opt=None):
    """(optimizer, its ZeRO-1 state specs, an empty state of this rank's
    blocks) for ``api`` over ``layout``."""
    cfg = api.cfg
    if opt is None:
        opt = AdamW(lr=3e-4, **OPT_OVERRIDES.get(cfg.name, {}))
    data = 1 if layout is None else layout.size("data")
    shapes = global_shapes(api)
    specs = opt.state_pspecs(api.param_pspecs(), zero1=True, shapes=shapes,
                             data_size=data)

    def empty(dtype):
        return lambda ps, shp: torch.empty(
            local_shape(tuple(shp.shape), ps, layout), dtype=dtype)

    state = AdamState(
        0, _map_specs(empty(opt.moment_dtype), specs.m, shapes),
        _map_specs(empty(opt.moment_dtype), specs.v, shapes),
        _map_specs(empty(torch.float32), specs.master, shapes)
        if opt.keep_master else None)
    return opt, specs, state


def _step_call(api, cell, layout, params, microbatch, opt=None):
    """(the step's callable with its arguments bound, the optimizer
    state or None) for one cell."""
    if cell.kind == "train":
        opt, specs, state = opt_setup(api, layout, opt)
        # ZeRO-2 over a data axis; one data rank has nothing to split
        zero = layout is not None and layout.size("data") > 1
        step = make_train_step(api, opt, microbatch=microbatch,
                               layout=layout,
                               accum_pspecs=specs.m if zero else None)
        batch, = cell.args
        return (lambda: step(params, state, batch)), state
    if cell.kind == "prefill":
        fn = make_prefill(api, cell.seq_len, layout)
        batch, = cell.args
        return (lambda: fn(params, batch)), None
    fn = make_serve_step(api, layout)
    token, cache, pos = cell.args
    return (lambda: fn(params, cache, token, pos)), None


def step_microbatch(cell, layout, microbatch: int = TRAIN_MICROBATCH) -> int:
    """The train step's microbatches: ``microbatch``, or fewer where a
    microbatch would hold less than one row a data rank (the port cuts
    each microbatch's rows over the data ranks; 2 x 16 x 16 has 32 of
    them for 256 rows, so 8 microbatches of 32 rows, one row a rank, as
    16 x 16's 16 of 16)."""
    n_dp = Ctx(layout).n_dp
    return max(1, min(microbatch, cell.batch // n_dp))


def trace_real_step(cfg, shape: str, layout, *, microbatch=TRAIN_MICROBATCH,
                    opt=None, cell=None, flops: bool = False):
    """Program A: the production step at full depth, traced once under
    ``MemTracker`` (call it under ``fake_tensors()`` and a fake group).
    Returns (cell, memory dict, the step's FLOPs under ``FlopCounterMode``
    with ``flops``, else None). ``cell`` may be given (a ``Cell`` of other
    inputs: chip_smoke's one-card check)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    api = build(cfg)
    cell = cell or input_specs(cfg, shape, layout, api)
    params = api.abstract_params(layout=layout)
    microbatch = step_microbatch(cell, layout, microbatch)
    call, state = _step_call(api, cell, layout, params, microbatch, opt)
    args = (params, state, cell.args)
    argument = nbytes(args)
    mt = MemTracker()
    mt.track_external(*[t for t in tree_leaves(args)
                        if isinstance(t, torch.Tensor)])
    fc = FlopCounterMode(display=False) if flops else contextlib.nullcontext()
    with mt, fc:
        call()
    peak = max((snap.get("Total", 0) for snap in
                mt.get_tracker_snapshot("peak").values()), default=0)
    peak = max(peak, argument)
    return cell, {"argument_bytes": argument, "peak_bytes_est": peak,
                  "temp_bytes": peak - argument,
                  "fits_80GB": bool(peak < CARD_BYTES)}, \
        float(fc.get_total_flops()) if flops else None


def _count(fn):
    """FLOPs, bytes and collectives of ``fn()``."""
    with FlopCounterMode(display=False) as fc, \
            cost_analysis.BytesCounter() as bc, \
            cost_analysis.CollectiveCounter() as cc:
        fn()
    colls = cc.summary()
    return {"flops": float(fc.get_total_flops()), "bytes": float(bc.bytes),
            "coll": colls["wire_bytes_per_device"], "coll_s": cc.seconds,
            "coll_per_op": {k: v["wire_bytes"]
                            for k, v in colls["per_op"].items()},
            "coll_counts": {k: v["count"]
                            for k, v in colls["per_op"].items()}}


def _combine(p1, p2, G, scale=1.0, extra=None):
    """total(G) = p1 + (G-1)(p2-p1), then x scale, then + extra."""
    def lin(a, b):
        return scale * (a + (G - 1) * (b - a))
    out = {k: lin(p1[k], p2[k]) for k in ("flops", "bytes", "coll",
                                          "coll_s")}
    for key in ("coll_per_op", "coll_counts"):
        ops = set(p1[key]) | set(p2[key])
        out[key] = {o: lin(p1[key].get(o, 0), p2[key].get(o, 0))
                    for o in ops}
    if extra is not None:
        for k in ("flops", "bytes", "coll", "coll_s"):
            out[k] += extra[k]
        for key in ("coll_per_op", "coll_counts"):
            for o, v in extra[key].items():
                out[key][o] = out[key].get(o, 0) + v
    return out


def _probe(cfg, shape: str, layout, g: int):
    """The cost probe at ``g`` groups: one microbatch's gradients (train,
    reduce-scattered into the ZeRO-2 blocks), the prefill or the decode
    step, counted under ``set_probe_mode``."""
    rcfg = _reduced_depth(cfg, g)
    api = build(rcfg)
    cell = input_specs(rcfg, shape, layout, api)
    params = api.abstract_params(layout=layout)
    set_probe_mode(True)
    try:
        if cell.kind == "train":
            opt, specs, _ = opt_setup(api, layout)
            batch, = cell.args
            mb = {k: v[:v.shape[0] // TRAIN_MICROBATCH]
                  for k, v in batch.items()}
            grads = make_train_step(api, opt, layout=layout,
                                    accum_pspecs=specs.m).grads
            return _count(lambda: grads(params, mb))
        call, _ = _step_call(api, cell, layout, params, 1)
        return _count(call)
    finally:
        set_probe_mode(False)


def _opt_probe(cfg, layout):
    """The optimizer update at full depth (elementwise: counted once a
    step): AdamW on the rank's ZeRO blocks, the parameters all-gathered
    back."""
    api = build(cfg)
    opt, specs, state = opt_setup(api, layout)
    params = api.abstract_params(layout=layout)
    grads = tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32),
                     zero_blocks(params, api.param_pspecs(), specs.m,
                                 layout))
    return _count(lambda: zero_update(opt, grads, state, params,
                                      api.param_pspecs(), specs.m, layout))


def cell_tag(arch: str, shape: str, multi_pod: bool) -> str:
    """A cell's file name, without ".json" (the reference's)."""
    return f"{arch}__{shape}__{'multi' if multi_pod else 'single'}"


def dryrun_cell(arch: str, shape: str, multi_pod: bool,
                variant: str = "base", probes: bool = True,
                tensors: str = "fake", attn_shard=None) -> dict:
    """One cell's dry run (the reference's JSON keys; ``trace_s`` for its
    ``compile_s``, ``fits_80GB`` for ``fits_16GB``); ``attn_shard``
    overrides the config's attention split."""
    cfg = get_config(arch)
    if attn_shard:
        cfg = dataclasses.replace(cfg, attn_shard=attn_shard)
    ok, why = cell_supported(cfg, shape)
    mesh_name, n = MESHES[multi_pod]
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    with fake_world(n), fake_tensors(tensors):
        layout = make_production_mesh(multi_pod=multi_pod)
        t0 = time.time()
        cell, memory, _ = trace_real_step(cfg, shape, layout)
        t_trace = time.time() - t0
        result = {
            "arch": arch, "shape": shape, "variant": variant,
            "mesh": mesh_name, "status": "ok", "kind": cell.kind,
            "seq_len": cell.seq_len, "batch": cell.batch,
            "tokens_per_step": cell.tokens_per_step,
            "microbatch": (step_microbatch(cell, layout)
                           if cell.kind == "train" else None),
            "trace_s": round(t_trace, 2),
            "device": ("meta" if tensors == "meta"
                       else str(trace_device())),
            "memory": memory,
            "params_total": cfg.param_count(),
            "params_active": cfg.active_param_count(),
        }
        if not probes or multi_pod:
            return result

        # ---- cost probes (single-pod roofline) ----
        t0 = time.time()
        p1 = _probe(cfg, shape, layout, 1)
        p2 = _probe(cfg, shape, layout, 2)
        G = cfg.n_groups
        if cell.kind == "train":
            cost = _combine(p1, p2, G, scale=TRAIN_MICROBATCH,
                            extra=_opt_probe(cfg, layout))
        else:
            cost = _combine(p1, p2, G)
        t_probe = time.time() - t0
    rl = dataclasses.replace(
        cost_analysis.roofline_terms(cost["flops"], cost["bytes"],
                                     cost["coll"]),
        collective_s=cost["coll_s"])
    mf = 6.0 if cell.kind == "train" else 2.0
    model_flops = mf * cfg.active_param_count() * cell.tokens_per_step
    result.update({
        "probe_s": round(t_probe, 2),
        "flops_per_device": cost["flops"],
        "bytes_per_device": cost["bytes"],
        "coll_bytes_per_device": cost["coll"],
        "coll_per_op": cost["coll_per_op"],
        "coll_counts": cost["coll_counts"],
        "roofline": {
            "compute_s": rl.compute_s, "memory_s": rl.memory_s,
            "collective_s": rl.collective_s, "dominant": rl.dominant,
            "bound_time_s": rl.bound_time_s,
            "rates": "H100 SXM5 80 GB data sheet (700 W): 989e12 bf16 "
                     "FLOP/s, 3.35e12 B/s HBM3, 450e9 B/s NVLink within "
                     "a node of 8, 50e9 B/s a NIC across nodes",
        },
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / layout.size(layout.axes),
        "useful_flops_ratio": (model_flops / layout.size(layout.axes)
                               / cost["flops"] if cost["flops"] else 0.0),
    })
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(ARTIFACT_DIR))
    ap.add_argument("--variant", default="base",
                    help="label for perf-iteration artifacts")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--remat-policy", default="minimal",
                    choices=("minimal", "save_tp"))
    ap.add_argument("--kv-chunk", type=int, default=0,
                    help="override attention kv_chunk (0 = default)")
    ap.add_argument("--attn-shard", default=None,
                    choices=("heads", "head_dim", "replicated"))
    ap.add_argument("--meta", action="store_true",
                    help="trace on meta tensors (the same counts, faster)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --all")
    saved = dict(FLAGS)
    FLAGS["flash"] = not args.no_flash
    FLAGS["remat_policy"] = args.remat_policy
    if args.kv_chunk:
        FLAGS["kv_chunk"] = args.kv_chunk
    try:
        _sweep(args)
    finally:
        FLAGS.update(saved)


def _sweep(args):
    """The cells ``main``'s arguments name, one JSON each under
    ``--out``; raises SystemExit naming how many failed."""
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = ([(a, s) for a in ARCH_IDS for s in SHAPES]
             if args.all else [(args.arch, args.shape)])

    failures = 0
    t_all = time.time()
    for arch, shape in cells:
        for mp in meshes:
            tag = cell_tag(arch, shape, mp)
            if args.variant != "base":
                tag += f"__{args.variant}"
            out_path = out_dir / (tag + ".json")
            if out_path.exists() and not args.force:
                print(f"[skip-cached] {tag}", flush=True)
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            t0 = time.time()
            try:
                res = dryrun_cell(arch, shape, mp, variant=args.variant,
                                  probes=not args.no_probes,
                                  tensors="meta" if args.meta else "fake",
                                  attn_shard=args.attn_shard)
            except Exception as e:  # noqa: BLE001
                failures += 1
                res = {"arch": arch, "shape": shape,
                       "mesh": MESHES[mp][0],
                       "status": "error", "error": repr(e),
                       "traceback": traceback.format_exc()}
            out_path.write_text(json.dumps(res, indent=1))
            status = res["status"]
            extra = ""
            if status == "ok" and "roofline" in res:
                extra = (f" dominant={res['roofline']['dominant']}"
                         f" useful={res.get('useful_flops_ratio', 0):.2f}"
                         f" mem_ok={res['memory']['fits_80GB']}")
            elif status == "ok":
                extra = f" mem_ok={res['memory']['fits_80GB']}"
            print(f"  -> {status}{extra} ({time.time() - t0:.0f}s)",
                  flush=True)
    print(f"[dryrun] {len(cells) * len(meshes)} cells, "
          f"{time.time() - t_all:.0f}s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
