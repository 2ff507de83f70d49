"""The port's spans matched with the device trace of a ``--trace 1``
window.

The port's recorder (``repro_torch.trace``) stamps its spans with
``time.time_ns()``, the clock of the profiler's records. A device record
(a kernel, a copy, a fill) is launched by a runtime call on the host that
carries the same correlation id; the record belongs to the innermost span
that was open when that call began. The gaps between device records
(the device idle) are split the same way, by the innermost span open
during each part of the gap, or none: the caller's loop between calls
into the port.

``attach`` makes what a run keeps under ``run["spans"]``: the recorder's
snapshots of set-up and of the window, the kernel launches of the window,
and ``attribution`` (``attribute``), which the span readers of
``perfbench/metrics/`` read.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

from perfbench.bench.trace import DEVICE_CALL, short

OUTSIDE = "(outside)"
# K1's kernels (``spdtw_tiles_gram``; the thread template is K2's too) and
# K3's (``krdtw_gram``; K4 shares them), by short name
K1_KERNEL = re.compile(r"^(gram|thread)_kernel\b")
K3_KERNEL = re.compile(r"^(narrow|regs|wide)_kernel\b")


def raw_records(prof) -> tuple:
    """(device records [(start_ns, duration_ns, name, correlation)],
    runtime calls {correlation: (start_ns, end_ns)}) of a profiler
    session."""
    from torch.autograd import DeviceType
    dev, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.start_ns(), e.duration_ns(), e.name(),
                        e.correlation_id()))
        elif DEVICE_CALL.match(e.name()):
            calls[e.correlation_id()] = (e.start_ns(), e.end_ns())
    return dev, calls


def timeline(spans: list) -> list:
    """The spans as sorted, disjoint segments [(start_ns, end_ns, id)],
    each of the innermost span open over it (the deepest; the latest
    started among equals)."""
    by_id = {s["id"]: s for s in spans}
    depth = {}

    def depth_of(sid):
        if sid not in depth:
            parent = by_id[sid]["parent"]
            depth[sid] = 0 if parent not in by_id else depth_of(parent) + 1
        return depth[sid]

    events = sorted([(s["start_ns"], 1, s["id"]) for s in spans]
                    + [(s["end_ns"], 0, s["id"]) for s in spans])
    active, out, prev = {}, [], None
    for t, opens, sid in events:
        if active and t > prev:
            out.append((prev, t, max(active.values())[2]))
        if opens:
            active[sid] = (depth_of(sid), by_id[sid]["start_ns"], sid)
        else:
            active.pop(sid, None)
        prev = t
    return out


def busy_gaps(dev: list) -> list:
    """The idle gaps [(start_ns, end_ns)] between the busy union of the
    device records (``trace.summarize``'s gaps)."""
    gaps, end = [], None
    for start, dur, *_ in sorted(dev):
        if end is not None and start > end:
            gaps.append((end, start))
        if end is None or start + dur > end:
            end = start + dur
    return gaps


def attribute(dev: list, calls: dict, spans: list) -> dict:
    """Device records and idle gaps by the innermost span.

    ``by_span``: span name -> {"device_s", "records", "kernels": {short
    name: [seconds, records]}}, where a record goes to the span open at
    its runtime call's start (``OUTSIDE`` where none); records whose call
    the trace lacks are counted as ``unmatched``. ``gaps``: the idle
    seconds between device records, ``in_span_s`` the part any span
    covers, ``by_span`` each part by its innermost span. ``edge_us``: of
    the runtime calls inside a span, the least distance from the call's
    start to its span's start and to its end, in microseconds: how far
    the two clocks could disagree before a call would leave its span."""
    by_id = {s["id"]: s for s in spans}
    segs = timeline(spans)
    starts = [s[0] for s in segs]

    def open_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < segs[i][1]:
            return by_id[segs[i][2]]
        return None

    by_span = defaultdict(lambda: {"device_s": 0.0, "records": 0,
                                   "kernels": defaultdict(lambda: [0.0, 0])})
    unmatched = 0
    lead = trail = None
    for start, dur, name, corr in dev:
        call = calls.get(corr)
        if call is None:
            unmatched += 1
            continue
        s = open_at(call[0])
        b = by_span[OUTSIDE if s is None else s["name"]]
        b["device_s"] += dur / 1e9
        b["records"] += 1
        k = b["kernels"][short(name)]
        k[0] += dur / 1e9
        k[1] += 1
        if s is not None:
            d0, d1 = call[0] - s["start_ns"], s["end_ns"] - call[0]
            lead = d0 if lead is None else min(lead, d0)
            trail = d1 if trail is None else min(trail, d1)
    gap_by = defaultdict(float)
    idle = covered = 0
    for a, b in busy_gaps(dev):
        idle += b - a
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        inside = 0
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                gap_by[by_id[segs[i][2]]["name"]] += (hi - lo) / 1e9
                inside += hi - lo
            i += 1
        covered += inside
        if b - a > inside:
            gap_by[OUTSIDE] += (b - a - inside) / 1e9
    return {
        "by_span": {n: {**v, "kernels": {k: list(x)
                                         for k, x in v["kernels"].items()}}
                    for n, v in by_span.items()},
        "unmatched": unmatched,
        "gaps": {"idle_s": idle / 1e9, "in_span_s": covered / 1e9,
                 "by_span": dict(gap_by)},
        "edge_us": None if lead is None else [lead / 1e3, trail / 1e3],
    }


def attach(prof, setup: dict, window: dict) -> dict:
    """What a traced run keeps under ``run["spans"]``: the recorder's
    snapshots ``setup`` (taken as the window opened, then the recorder
    reset) and ``window`` (taken as it closed), the window's kernel
    launches by entry point, and the attribution of the session's
    device records to the window's spans."""
    dev, calls = raw_records(prof)
    return {"setup": setup, "window": window,
            "launches": {k: v - setup["launches"].get(k, 0)
                         for k, v in window["launches"].items()},
            "attribution": attribute(dev, calls, window["spans"])}


def kernel_s(attribution: dict, span_names, pattern) -> tuple:
    """(seconds, records) of the kernels matching ``pattern`` launched
    inside the spans named ``span_names``."""
    s = n = 0
    for name in span_names:
        for k, (sec, cnt) in attribution["by_span"].get(
                name, {"kernels": {}})["kernels"].items():
            if pattern.match(k):
                s += sec
                n += cnt
    return s, n


def span_ms(snapshot: dict, name: str) -> float:
    """Milliseconds of every span ``name`` in a snapshot, summed."""
    return sum(s["end_ns"] - s["start_ns"] for s in snapshot["spans"]
               if s["name"] == name) / 1e6
