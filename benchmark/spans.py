"""The program's own spans (``gmres_tpu_torch.utils.profiling``), for the
per-layer readers that read them.

The window and the harness's traced call run with the spans off.  The
first of these readers to be asked in a traced run collects the spans of
the same cell in a fresh process (a profiler session, such as the
harness's traced call, leaves the host of its process slower for the
rest of it), in this order:

1. set-up with the spans on: the cell's operator made, staged and its
   preconditioner built and moved (``stage.*``, ``precond.*``);
2. one warm-up call with the spans off;
3. one call with the spans on and the profiler off: the host-clock
   readers read this call;
4. one traced call with the spans on, under the profiler with the device's
   records only (as ``trace.py``'s): each kernel joined, by its
   correlation id, to the CUDA runtime record of its launch, whose host
   time falls inside the innermost span that launched it.

The right-hand sides are the pool of the run's ``--seed``, the first
``rhs_per_call`` of them, as the harness's traced call takes; the
traffic is the one whose ``rhs_per_call`` is the window's.  A program
without the spans (no ``recording``) gives nothing to read, and nothing
is run.  The collection prints ``idle_by_span`` (the device's idle time
grouped by the innermost span open at the launch that ended each gap) and
the kernels by span to standard error, and writes the traced call's
Chrome trace, with the spans on a track of their own, beside the
harness's as ``<workload>.spans.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import multiprocessing
import sys
import traceback
from concurrent.futures import ProcessPoolExecutor

from benchmark import harness, trace

ATTR = "program_spans"
# the names of the host's CUDA runtime and driver API records (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...)
RUNTIME = "cu"


@dataclasses.dataclass
class Collected:
    """What ``gather`` recorded for the readers."""

    setup: list         # the set-up's spans
    traced: list        # the traced call's spans
    kernels: list       # the traced call's device operations: (name, start_ns, end_ns, launch_ns)
    loop_steps: int     # the traced call's Arnoldi steps, its lanes stepping together
    added: list         # the spans of the call before it, the profiler off


def _argv() -> argparse.Namespace:
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--workload", default="cell")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_known_args(sys.argv[1:])[0]


def _traffic(lanes: int) -> dict | None:
    """The traffic mix whose calls take ``lanes`` right-hand sides, where
    exactly one does."""
    mixes = [json.loads(p.read_text()) for p in (harness.BENCH / "traffic").glob("*.json")]
    found = [t for t in mixes if t["rhs_per_call"] == lanes]
    return found[0] if len(found) == 1 else None


def device_records(prof) -> list:
    """The profiler's device operations, each with the host time of the
    runtime call that launched it (joined by correlation id; None where
    no such record was kept), in nanoseconds of the spans' clock."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() for e in events
              if e.device_type() != cuda and e.name().startswith(RUNTIME)}
    return sorted(((e.name(), e.start_ns(), e.end_ns(), launch.get(e.correlation_id()))
                   for e in events if e.device_type() == cuda), key=lambda k: k[1])


def innermost(spans: list, times: list) -> list:
    """For each of ``times`` (nanoseconds), the index of the innermost span
    open at it, or None.  The spans nest, as one thread's do."""
    order = sorted(range(len(spans)), key=lambda i: spans[i].start_ns)
    end = [s.end_ns if s.end_ns is not None else float("inf") for s in spans]
    out = [None] * len(times)
    stack, j = [], 0
    for t_idx in sorted(range(len(times)), key=lambda i: times[i]):
        t = times[t_idx]
        while j < len(order) and spans[order[j]].start_ns <= t:
            s = order[j]
            while stack and end[stack[-1]] < spans[s].start_ns:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and end[stack[-1]] < t:
            stack.pop()
        out[t_idx] = stack[-1] if stack else None
    return out


def layer_of(spans: list, kernels: list) -> list:
    """Each kernel's layer: the name of the innermost span open at its
    launch, ``None`` where it was launched outside every span or its launch
    was not recorded."""
    known = [i for i, k in enumerate(kernels) if k[3] is not None]
    inner = innermost(spans, [kernels[i][3] for i in known])
    out = [None] * len(kernels)
    for i, s in zip(known, inner):
        out[i] = None if s is None else spans[s].name
    return out


def idle_by_span(spans: list, kernels: list, top: int = 10) -> list:
    """The device's idle seconds, each gap between its operations given to
    the innermost span open at the launch of the operation that ended it
    (``unattributed`` where none was, or the launch was not recorded),
    largest first."""
    names = layer_of(spans, kernels)
    gaps: dict[str, float] = {}
    end = None
    for (_, a, b, _), name in sorted(zip(kernels, names), key=lambda kn: kn[0][1]):
        if end is not None and a > end:
            key = name or "unattributed"
            gaps[key] = gaps.get(key, 0.0) + (a - end) * 1e-9
        end = b if end is None else max(end, b)
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel (copies and memsets left out,
    as ``kernels_per_step`` counts)."""
    return not name.startswith(("Memcpy", "Memset"))


def collect(run) -> Collected | None:
    """The cell's spans, collected once a run (kept on ``run``) in a fresh
    process; None where the program has no spans or the run is not a
    traced one."""
    if hasattr(run, ATTR):
        return getattr(run, ATTR)
    found = None
    profiling = importlib.import_module("gmres_tpu_torch.utils.profiling")
    traffic = _traffic(len(run.calls[0]["iters"])) if run.calls else None
    if hasattr(profiling, "recording") and run.events is not None and traffic is not None:
        args = _argv()
        try:
            with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
                found = pool.submit(gather, run.config, traffic, args.workload, args.seed,
                                    str(harness.TRACE_DIR)).result()
        except Exception:  # a reader that cannot read leaves its metric out
            traceback.print_exc(file=sys.stderr)
        else:
            _report(found)
    setattr(run, ATTR, found)
    return found


def gather(config: dict, traffic: dict, workload: str, seed: int, trace_dir: str) -> Collected:
    """Set-up, a warm-up call, the call read on the host clock and the
    traced call, in this order, in a process in which no profiler has run
    before the host is timed (a profiler session leaves the host slower
    for the rest of its process, PERF.md)."""
    import torch

    from gmres_tpu_torch.utils import profiling

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.Cell(workload, 1, config, traffic, [], [])
    with profiling.recording() as setup_spans:
        setup = harness.Setup(cell, device, {})
    B = setup.pool(seed)
    idx = [j % len(B) for j in range(setup.lanes)]
    setup.call(B, idx, record_history=True)
    with profiling.recording() as added:
        setup.call(B, idx, record_history=True)
    with profiling.recording() as traced:
        with profiling.trace(trace_dir, f"{workload}.spans.json", host=False) as prof:
            results = setup.call(B, idx, record_history=True)
    kernels = device_records(prof) if device == "cuda" else []
    steps = harness.loop_steps([[h["k"] for h in r.history] for r in results])
    return Collected(list(setup_spans), list(traced), kernels, steps, list(added))


def self_seconds(spans: list) -> dict:
    """Each span name's self time in seconds, summed: a span's duration less
    its children's."""
    own = [(s.end_ns - s.start_ns) * 1e-9 if s.end_ns is not None else 0.0 for s in spans]
    out = {}
    for i, s in enumerate(spans):
        out[s.name] = out.get(s.name, 0.0) + own[i]
        if s.parent is not None:
            out[spans[s.parent].name] -= own[i]
    return out


def _report(c: Collected) -> None:
    """What the metrics do not keep, on standard error: where the host's
    time went in the call read on the host clock (each span's self time),
    the traced call's idle time by span, its share under a span below
    ``solve``, and each span's kernels."""
    print(f"spans host_self_s {json.dumps(self_seconds(c.added))}", file=sys.stderr)
    if not c.kernels:
        return
    idle = idle_by_span(c.traced, c.kernels, top=10 ** 6)
    total = sum(v for _, v in idle)
    named = sum(v for k, v in idle if k not in ("unattributed", "solve"))
    by_span: dict[str, dict[str, int]] = {}
    for (name, *_), layer in zip(c.kernels, layer_of(c.traced, c.kernels)):
        if is_kernel(name):
            groups = by_span.setdefault(layer or "unattributed", {})
            groups[trace.group(name)] = groups.get(trace.group(name), 0) + 1
    unlaunched = sum(k[3] is None for k in c.kernels)
    print(f"spans idle_by_span {json.dumps(idle)} idle_s {total} below_solve_share "
          f"{named / total if total else None} launches_unrecorded {unlaunched} of "
          f"{len(c.kernels)} loop_steps {c.loop_steps}", file=sys.stderr)
    print(f"spans kernels_by_span {json.dumps(by_span)}", file=sys.stderr)


def seconds(spans: list, name: str) -> list:
    """The durations of the spans named ``name``, in seconds."""
    return [(s.end_ns - s.start_ns) * 1e-9 for s in spans
            if s.name == name and s.end_ns is not None]


def mean_ms(spans: list, name: str) -> float | None:
    d = seconds(spans, name)
    return 1e3 * sum(d) / len(d) if d else None
