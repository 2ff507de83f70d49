"""The device trace of a ``--trace 1`` window: torch.profiler with CUDA
activity only (the device records and the runtime calls behind them, no
operator records, so the window keeps its pace), read from the
profiler's raw records.

The profiler has been seen to lose device records from about 30 s after
a process's first session, so the window is the process's only session,
and the records are counted against the runtime calls that put them on
the device: a trace that lost any says so in ``records``.
"""
from __future__ import annotations

import re
from collections import defaultdict

# the port's hand-written kernels (csrc/*.cu, each in an anonymous
# namespace), and the K_rdtw ones among them (K3 and K4 share them)
PORT_KERNEL = re.compile(
    r"^(void )?\(anonymous namespace\)::(banded|banded_thread|banded_wide|"
    r"gram|narrow|paired|pairs_bwd|pairs_fwd|regs|thread|tiles_bwd|"
    r"tiles_fwd|wavefront|wavefront_wide|wide)_kernel\b")
KRDTW_KERNEL = re.compile(
    r"^(void )?\(anonymous namespace\)::(narrow|regs|wide)_kernel\b")
# a host call that puts one record on the device (a kernel launch, a copy,
# a fill)
DEVICE_CALL = re.compile(r"^cu(da)?(LaunchKernel|Memcpy|Memset)")


def session():
    """A profiler over the CUDA activity; use as a context manager."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def short(name: str) -> str:
    """A device record's name without its return type, namespaces and
    parameter list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(", 1)[0]
    for ns in ("at::native::", "at::", "cub::", "(anonymous namespace)"):
        name = name.replace(ns, "")
    return name if len(name) <= 60 else name[:57] + "..."


def summarize(prof, window_s: float) -> dict:
    """What the session saw: device records by name, the busy union, the
    port's kernels apart from the rest, the K_rdtw records in launch
    order, the idle gaps by the records around them, and the record
    count against the runtime calls."""
    from torch.autograd import DeviceType
    ev = list(prof.profiler.kineto_results.events())
    dev = sorted(((e.start_ns(), e.duration_ns(), e.name()) for e in ev
                  if e.device_type() == DeviceType.CUDA), key=lambda r: r[0])
    calls = sum(1 for e in ev if e.device_type() != DeviceType.CUDA
                and DEVICE_CALL.match(e.name()))
    by_name = defaultdict(lambda: [0.0, 0])
    busy_ns = 0
    end = None
    gaps = defaultdict(float)
    prev = None
    for start, dur, name in dev:
        by_name[name][0] += dur / 1e9
        by_name[name][1] += 1
        if end is None or start >= end:
            if end is not None:
                gaps[f"{short(prev)} -> {short(name)}"] += (start - end) / 1e9
            busy_ns += dur
            end = start + dur
        elif start + dur > end:
            busy_ns += start + dur - end
            end = start + dur
        prev = name
    port_s = sum(s for n, (s, _) in by_name.items() if PORT_KERNEL.match(n))
    total_s = sum(s for s, _ in by_name.values())
    return {
        "window_s": window_s,
        "busy_s": busy_ns / 1e9,
        "device_s": total_s,
        "port_s": port_s,
        "other_s": total_s - port_s,
        "krdtw_s": [dur / 1e9 for _, dur, n in dev if KRDTW_KERNEL.match(n)],
        "by_name": {n: tuple(v) for n, v in by_name.items()},
        "gaps": dict(gaps),
        "records": {"device": len(dev), "runtime_calls": calls},
    }


def breakdown(summary: dict, top: int = 10) -> dict:
    """The contract's ``breakdown``: the device operations that took most
    time and the idle gaps that added up to most, [name, seconds] each."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[short(n), s] for n, (s, _) in ops[:top]],
            "idle_gaps": [[n, s] for n, s in gaps[:top]]}
