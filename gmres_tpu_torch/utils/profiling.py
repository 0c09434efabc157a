"""Profiling hooks (``gmres_tpu/utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the host and, where a
  card is present, its device kernels around a region, written into
  ``log_dir`` as a Chrome trace (``chrome://tracing`` or Perfetto); the
  profiler is yielded, so the caller can also read ``key_averages()`` or
  ``events()``;
- ``PhaseTimers``: named wall-clock phases with a dict export;
- ``seconds_per_call``: a callable's device time a call, over CUDA events
  around a loop of calls on the card (the host clock on the CPU);
- ``solve_metrics``: derived solver metrics (nnz/s, iterations/s), the JAX
  package's keys and arithmetic.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace.json"):
    """Profile the region on the CPU and, when torch sees a CUDA device, on
    the card; write ``log_dir/name`` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


class PhaseTimers:
    def __init__(self):
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (time.perf_counter() - t0)

    def as_dict(self) -> dict[str, float]:
        return dict(self.seconds)


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


def solve_metrics(result, nnz: int) -> dict:
    """Derived metrics for a GmresResult.  Each inner iteration does one SpMV
    over nnz entries (plus the preconditioner's sweeps, not counted here)."""
    secs = max(result.solve_seconds, 1e-12)
    return {
        "total_iters": result.total_iters,
        "restarts": result.restarts,
        "converged": result.converged,
        "solve_seconds": result.solve_seconds,
        "prec_seconds": result.prec_seconds,
        "spmv_nnz_per_s": result.total_iters * nnz / secs,
        "iters_per_s": result.total_iters / secs,
    }
