"""The traced stretch: one call of the cell's entry point under
``torch.profiler``, and what the per-layer readers and the breakdown read
from it.

Only the device is traced (``ProfilerActivity.CUDA``: CUPTI's kernel,
copy and runtime records), not the host's torch operators, which keeps the
host's slowdown to 1.1-1.8x on an H100 (PERF.md).  The device's operations are kept
as ``(name, start_us, end_us)``; ``busy_us`` is the union of their
intervals.  The Chrome trace of the stretch is written to
``build/benchmark/trace/<workload>.json`` in the checkout, overwritten by
the next traced run of the cell.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

# names for the breakdown only: the readers keep their own patterns
GROUPS = (
    ("K1 residual", r"dia_spmv_kernel<\s*double\s*,\s*(true|1)\b"),
    ("K1", r"dia_spmv_kernel"),
    ("K2x2", r"basis_gram_kernel<[^>]*,\s*2\s*>"),
    ("K2", r"basis_gram_kernel"),
    ("K3 GRAM", r"basis_update_gram"),
    ("K3 SUMSQ", r"basis_update_kernel"),
    ("K4", r"basis_axpy"),
    ("K5", r"sell_"),
    ("K6", r"ilu_levels_kernel"),
    ("K7", r"basis_mgs"),
)


def group(name: str) -> str:
    """A short name of a device operation: its kernel's K-number, or the
    torch kernel's name without its template arguments."""
    for label, pat in GROUPS:
        if re.search(pat, name):
            if label == "K1":
                m = re.search(r"dia_spmv_kernel<\s*(\w+)\s*,[^,]*,[^,]*,\s*(\d+)\s*>", name)
                if m:
                    return f"K1 {m.group(1)} lanes {m.group(2)}"
            return label
    short = name.removeprefix("void ").split("(")[0]
    head = short.split("<")[0]
    functor = re.search(r"\w*(?:Functor|_cuda|Op)\w*", short[len(head):])
    return (f"{head}<{functor.group(0)}>" if functor else head)[:96]


def profile_call(fn, device, out_path: Path):
    """Run ``fn()`` under the profiler; return (fn's result, the device
    operations, the traced wall in seconds).  On a machine without a card
    the host is traced instead and no device operation is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda e: e[1])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    return out, events, wall


def busy_us(events) -> float:
    """The union of the operations' intervals, in microseconds."""
    busy, end = 0.0, float("-inf")
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, by short name, and the
    idle gaps summed by the pair of operations around them (what the host
    enqueued between them), in seconds."""
    ops: dict[str, float] = {}
    gaps: dict[str, float] = {}
    end, prev = None, None
    for name, a, b in sorted(events, key=lambda e: e[1]):
        g = group(name)
        ops[g] = ops.get(g, 0.0) + (b - a) * 1e-6
        if end is not None and a > end:
            key = f"{prev} -> {g}"
            gaps[key] = gaps.get(key, 0.0) + (a - end) * 1e-6
        if end is None or b >= end:
            end, prev = b, g
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}
