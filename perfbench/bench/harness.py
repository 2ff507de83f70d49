"""One run of one cell: data from the seed, set-up, the window, the
comparison with the plain reference, and the result line.

``run_cell`` is the whole run after the look for a card (``run.py`` makes
that look); tests call it on the CPU at a small size, with the program
swapped for a broken one or for the control.
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time
from pathlib import Path

import torch

from perfbench.bench import card, cells, pools, seeds, trace as tracing

# top-level module names no run may hold once its window has closed: JAX
# and the JAX package the port was made from. Names are compared whole,
# so the port (``repro_torch``) does not match ``repro``.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every
    module the process holds)."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, to
    its clock tick)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(root, name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", cfg_over=None, wl_over=None,
             program=None) -> dict:
    """Run cell ``name`` and return the contract's result (the dict whose
    JSON is the last line). ``cfg_over`` / ``wl_over`` replace entries of
    the configuration and workload files (tests shrink a cell with them);
    ``program`` replaces the driver's ``Program`` class."""
    cell = cells.Cell(Path(root), name)
    cfg = {**cell.cfg, **(cfg_over or {})}
    wl = {**cell.wl, **(wl_over or {})}
    device = torch.device(device)
    drv = cells.driver(wl["driver"])
    loop = cells.traffic(wl["loop"])
    dev_info = card.describe(device)
    _log(f"card: {dev_info.get('smi', dev_info['kind'])}")
    torch.set_num_threads(min(4, torch.get_num_threads()))

    source = cells.data(cfg)
    data = source.cell_data(cfg, int(wl["pool_series"]), seed)
    setup_args, pool = source.on_device(data, device)
    prog = (program or drv.Program)(cfg, wl, device)
    timings = prog.setup(*setup_args)
    loop.warm(prog, pool, wl, seed)
    _sync(device)
    setup_s = process_age_s()
    _log(f"set-up {setup_s:.3f} s: {timings}")

    sampler = card.Sampler(device)
    prof = tracing.session() if trace else None
    if prof is not None:
        prof.__enter__()
    try:
        res = loop.drive(prog, pool, wl, seconds, seed)
        _sync(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        smi = sampler.stop()
    summary = tracing.summarize(prof, res["window_s"]) if trace else None
    mem_peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    counters = prog.counters(pools.rows(pool, 0, int(
        wl.get("job_series", wl.get("max_batch"))))) \
        if trace and hasattr(prog, "counters") else {}
    # a program with no learnt support (a model made from the seed) has
    # neither ``support`` nor ``kept``
    support = prog.support() if hasattr(prog, "support") else None
    kept = prog.kept() if hasattr(prog, "kept") else {}
    prog.release()
    del prog
    _free(device)

    # the comparison, once the program's state is freed
    t_ref = time.perf_counter()
    rng = seeds.seed_rng(seed, seeds.SAMPLE)
    numbers = drv.compare(cfg, wl, data, res, support, kept, rng, device)
    numbers["unanswered"] = float(res["attempted"] - res["answered"])
    ref_s = time.perf_counter() - t_ref
    limits = {**cfg["limits"], "unanswered": 0.0}
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in limits if k in numbers}
    correct = (set(limits) <= set(numbers)) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    run = {"cfg": cfg, "wl": wl, "setup_s": setup_s, "window": res,
           "timings": timings, "support": support, "trace": summary,
           "counters": counters}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        v = cells.reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_out = {k: dev_info[k] for k in ("platform", "kind", "count")}
    device_out["memory_peak_bytes"] = int(mem_peak)
    result = {"correct": bool(correct),
              "attempted": int(res["attempted"]),
              "failed": int(res["attempted"] - res["answered"]),
              "metrics": metrics, "device": device_out}
    if summary is not None:
        device_out["busy_s"] = summary["busy_s"]
        device_out["window_s"] = summary["window_s"]
        result["breakdown"] = tracing.breakdown(summary)
        result["records"] = summary["records"]
    result["run"] = {"seed": seed, "seconds": seconds,
                     "window_s": res["window_s"], "steps": res["steps"],
                     **({"support_cells": support["cells"]}
                        if support is not None else {}),
                     "reference_s": ref_s, "card": smi,
                     **{k: v for k, v in timings.items()}}
    result["checks"] = checks
    for k, c in checks.items():
        _log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    return result
