"""Profiling hooks (``gmres_tpu/utils/profiling.py``).

- ``span(name, **attrs)``: a named interval of the program's hot path, kept
  in memory while ``recording()`` is on and a shared no-op otherwise;
- ``recording()``: turn the spans on for a region and get their records;
- ``trace(log_dir)``: a ``torch.profiler`` trace of the host and, where a
  card is present, its device kernels around a region, with the program's
  spans on a track of their own, written into ``log_dir`` as a Chrome trace
  (``chrome://tracing`` or Perfetto); the profiler is yielded, so the
  caller can also read ``key_averages()`` or ``events()``;
- ``seconds_per_call``: a callable's device time a call, over CUDA events
  around a loop of calls on the card (the host clock on the CPU).

Spans are stamped with ``time.time_ns()``, the clock of the profiler's own
records (``kineto_results.trace_start_ns()`` and every event's
``start_ns()`` are nanoseconds of that epoch), so a span sits on the same
timeline as the profiler's operators, CUDA runtime calls and kernels: the
innermost span open at a launch names the layer of the kernel it launched.
The recorder is process-wide, as the profiler is, and assumes one thread
drives the solver.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span.  ``parent`` is the index, among the same
    recording's records, of the span open around it (None at the top);
    ``call`` is the index of its outermost span, shared by every span of one
    call of the program; ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int | None
    call: int
    attrs: dict


class _NoSpan:
    """The context ``span`` returns while recording is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_NO_SPAN = _NoSpan()
# the records of the current recording, and the indices of its open spans;
# None while recording is off
_records: list | None = None
_open: list = []


class _OpenSpan:
    __slots__ = ("name", "attrs", "index")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        records = _records
        parent = _open[-1] if _open else None
        self.index = len(records)
        rec = Span(self.name, 0, None, parent,
                   self.index if parent is None else records[parent].call, self.attrs)
        records.append(rec)
        _open.append(self.index)
        rec.start_ns = time.time_ns()
        return rec

    def __exit__(self, *exc):
        end = time.time_ns()
        if _records is not None and _open and _open[-1] == self.index:
            _open.pop()
            _records[self.index].end_ns = end
        return None


def span(name: str, **attrs):
    """A context around one layer's work, named ``name`` with ``attrs``
    (a cycle's ``i``, a step's ``k``, a call's entry and lanes).  While
    recording is off it returns one shared no-op context and reads no
    clock."""
    if _records is None:
        return _NO_SPAN
    return _OpenSpan(name, attrs)


@contextlib.contextmanager
def recording():
    """Record every span of the region; yields the list of ``Span``
    records, filled as the spans open and close.  Inside another recording
    it yields that recording's list and leaves it on at the end."""
    global _records
    if _records is not None:
        yield _records
        return
    records = _records = []
    _open.clear()
    try:
        yield records
    finally:
        _records = None
        _open.clear()


# the Chrome trace's process (track) of the spans
_SPAN_TRACK = "gmres_tpu_torch spans"


def _chrome_events(records, base_ns: int) -> list:
    """The spans as Chrome-trace complete events on one track of their own,
    their ``ts`` in microseconds after ``base_ns`` (the trace's
    ``baseTimeNanoseconds``); open spans are left out."""
    out = []
    for i, s in enumerate(records):
        if s.end_ns is None:
            continue
        args = {"index": i, "parent": s.parent, "call": s.call, **s.attrs}
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": _SPAN_TRACK, "tid": 0,
                    "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json", host: bool = True):
    """Profile the region on the CPU and, when torch sees a CUDA device, on
    the card, with the spans recorded; write ``log_dir/name`` when it ends,
    the spans on their own track.  ``host=False`` leaves the host's torch
    operators out where there is a card (CUPTI's kernel, copy and runtime
    records stay), which slows the host less."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording() as records:
        first = len(records)
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        spans = records[first:]
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_events(spans, doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)


# card cycles spun before a timed loop for each call in it (~0.1 ms at the
# H100's 1.98 GHz), so that the host has enqueued the whole loop before the
# first call starts
SPIN_CYCLES_PER_CALL = 200_000


def seconds_per_call(fn, trials: int, device) -> float:
    """Seconds a call of ``fn`` takes on ``device``, after one warm-up call:
    on a CUDA device the device time of ``trials`` calls back to back,
    between two CUDA events, the card spinning first while the host enqueues
    them (so a call shorter than its host enqueue is timed on the device,
    not at the enqueue rate); on the CPU the host clock around them."""
    import torch

    dev = torch.device(device)
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL * trials)
        start.record()
        for _ in range(trials):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / trials
    t0 = time.perf_counter()
    for _ in range(trials):
        fn()
    return (time.perf_counter() - t0) / trials
