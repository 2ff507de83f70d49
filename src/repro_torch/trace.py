"""Spans and counters inside the port, on the profiler's clock.

A recorder kept in memory, off by default:

    from repro_torch import trace
    trace.enable()
    with trace.span("cascade"):
        ...
        trace.count("cascade.dp_pairs", alive.sum())
    snap = trace.snapshot()      # spans, counts, kernel launch counts
    trace.disable()

``span(name)`` is a context manager. Off, it returns one shared object
that does nothing: a span site then costs one read of the module flag
``ON``, no clock read and no allocation. On, each span records an id,
its parent's id, its job (the id of its outermost span), its name, and
its start and end in ``time.time_ns()``: Unix-epoch nanoseconds, the
clock of ``torch.profiler``'s records (``_KinetoEvent.start_ns()``), so
a device record can be matched with the span that was open when the
runtime call that launched it began. A span measures host time and never
waits for the device, unless it is given ``sync=device`` (set-up phases,
whose spans then hold their phase's device work; the recorder must be
on for that too).

``enable(events=device)`` also marks each span on a CUDA device's
current stream: a timing event recorded as the span opens and another as
it closes, and ``snapshot()`` gives the span's ``device_ms``, the
stream's milliseconds between the two marks (the work launched inside the
span, and the stream's idle while it waited for the host there). Unlike
a profiler session it loses nothing however late in a process it runs.

``count(name, value)`` adds an int, or a 0-d device tensor summed on
its device with ``add_`` and read on the host only by ``snapshot()``.

Spans nest per thread: a thread's open spans are the parents of the
spans it opens. The spans and counts of every thread share one record.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch

ON = False
clock_ns = time.time_ns
# the CUDA device whose stream the spans mark with timing events (None:
# no events)
_events = None

_spans: list = []
_ints: dict = {}
_tensors: dict = {}
_ids = itertools.count(1)
_open = threading.local()
_lock = threading.Lock()
# the one span of a recorder that is off
_OFF = contextlib.nullcontext()

SPAN_KEYS = ("id", "parent", "job", "name", "start_ns", "end_ns")


def _mark():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(_events))
    return ev


class _Span:
    __slots__ = ("name", "sync", "id", "parent", "job", "start", "ev")

    def __init__(self, name: str, sync):
        self.name = name
        self.sync = sync

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.job = stack[-1].id, stack[-1].job
        else:
            self.parent, self.job = None, self.id
        stack.append(self)
        self.ev = None if _events is None else _mark()
        self.start = clock_ns()
        return self

    def __exit__(self, *exc):
        if self.sync is not None and torch.device(self.sync).type == "cuda":
            torch.cuda.synchronize(self.sync)
        end = clock_ns()
        _open.stack.remove(self)
        _spans.append((self.id, self.parent, self.job, self.name,
                       self.start, end)
                      + (() if self.ev is None else ((self.ev, _mark()),)))
        return False


def span(name: str, sync=None):
    """A context manager recording the span ``name`` while the recorder
    is on; ``sync`` (a device) makes its end wait for that device."""
    if not ON:
        return _OFF
    return _Span(name, sync)


def count(name: str, value) -> None:
    """Add ``value`` (an int, or a 0-d tensor summed where it lives) to
    the counter ``name`` while the recorder is on."""
    if not ON:
        return
    if isinstance(value, torch.Tensor):
        key = (name, value.device)
        with _lock:
            acc = _tensors.get(key)
            if acc is None:
                _tensors[key] = value.detach().to(
                    torch.float64 if value.is_floating_point()
                    else torch.int64).clone()
            else:
                acc.add_(value.detach().to(acc.dtype))
        return
    with _lock:
        _ints[name] = _ints.get(name, 0) + value


def enable(events=None) -> None:
    """Turn the recorder on (what it holds is kept); ``events`` (a device)
    marks the spans on its stream where it is a CUDA device."""
    global ON, _events
    ON = True
    _events = (events if events is not None
               and torch.device(events).type == "cuda" else None)


@contextlib.contextmanager
def paused():
    """The recorder off inside the block (a CUDA graph's capture, whose
    launches run only at its replays) and back as it was after."""
    global ON
    was, ON = ON, False
    try:
        yield
    finally:
        ON = was


def disable() -> None:
    """Turn the recorder off (what it holds is kept)."""
    global ON, _events
    ON = False
    _events = None


def reset() -> None:
    """Drop every recorded span and count."""
    with _lock:
        _spans.clear()
        _ints.clear()
        _tensors.clear()


def snapshot() -> dict:
    """What the recorder holds: ``spans`` (dicts of ``SPAN_KEYS``, in the
    order they ended, and ``device_ms`` where the span was marked on a
    stream: waits for its closing mark), ``counts`` (name -> number;
    reads each device counter once), ``launches`` (the kernels' launch
    counts) and ``clock`` (the clock's name)."""
    from repro_torch.kernels._build import launch_counts
    with _lock:
        spans = [dict(zip(SPAN_KEYS, s)) for s in _spans]
        for d, s in zip(spans, _spans):
            if len(s) > len(SPAN_KEYS):
                ev0, ev1 = s[-1]
                ev1.synchronize()
                d["device_ms"] = ev0.elapsed_time(ev1)
        counts = dict(_ints)
        tensors = list(_tensors.items())
    for (name, _), acc in tensors:
        v = acc.item()
        counts[name] = counts.get(name, 0) + v
    return {"clock": "time_ns", "spans": spans, "counts": counts,
            "launches": launch_counts()}
