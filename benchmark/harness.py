"""One run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the operator, the
solver's settings and the guarantee) and a traffic mix
(``traffic/<name>.json``: the entry point, right-hand sides a call and the
size of the pool of right-hand sides).  The run:

1. set-up, counted in ``setup_s`` from the process's start: the program's
   kernels loaded from the checkout's build directory (built there on the
   first run), the operator made by its generator (``operators/``), the
   pool of right-hand sides made from ``--seed`` (``inputs.py``) as
   ``b = A x_true`` in float64 by a plain product on the host and uploaded,
   ``stage()`` (``stage_s``), the preconditioner built and moved to the
   device where the configuration has one (``precond_build_s``), and one
   warm-up call of the cell's own shapes;
2. the window: whole calls in a closed loop with one caller, each from x0 =
   0 on the pool's next right-hand sides, until the first call that ends
   ``--seconds`` or more after the window opened.  The answers kept for
   the check (a sample of ``KEEP_ANSWERS`` drawn from the seed where there
   are more) are copied to the host as they are kept; the copies' seconds
   are the harness's and are taken out of the window's;
3. with ``--trace 1``, one more call, of the pool's first right-hand sides,
   under the profiler (``trace.py``);
4. the check, after the program's state is freed: the plain reference
   (``reference.py``) is built from the operator's CSR arrays and judges
   each kept answer: its float64 backward error against the
   configuration's tolerance, and the gap between the backward error the
   solve reported (its outer residual's) and the reference's; every
   answer's own ``converged`` flag must be set.

``solve_s`` is the window's wall over the right-hand sides solved in it
that did not fail.  The per-layer metrics are read by the modules in
``metrics/``, each given the ``Run`` record below.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark import inputs, trace
from benchmark.hoststats import HostWatch, clock_mhz, delta
from benchmark.operators import generator
from benchmark.reference import Reference

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TRACE_DIR = ROOT / "build" / "benchmark" / "trace"
# top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gmres_tpu")
# answers of the window kept for the check, at most (a reservoir sample)
KEEP_ANSWERS = 64


class NoResult(Exception):
    """The run prints no result line and exits with another code than 0."""


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_cell(workload: str, overrides: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``, its configuration file
    (with ``overrides`` merged in, for tests) and traffic file, and the
    metrics it reports."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    try:
        w = next(w for w in spec["workloads"] if w["name"] == workload)
    except StopIteration:
        raise NoResult(f"no workload named {workload!r} in BENCHMARK.json") from None
    c = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = _merge(json.loads((ROOT / c["file"]).read_text()), overrides or {})
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(workload, w["chips"], config, traffic, e2e, layer)


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads (``metrics/<name>.py``: ``read(run)``,
    a number, or None where it finds nothing to read)."""

    config: dict        # the configuration file
    n: int              # rows of the operator
    diagonals: int      # distinct diagonals of its pattern
    spans: dict         # set-up phases on the host clock, seconds
    window_s: float     # the untraced window's wall
    calls: list         # the window's calls: {"iters": [a lane's Arnoldi steps], "steps", "seconds", ...}
    events: list | None = None   # the traced call's device operations (name, start_us, end_us)
    cycles: list | None = None   # the traced call's Arnoldi steps a cycle, a list a lane


def loop_steps(cycles: list) -> int:
    """Arnoldi steps of a call's loop: a batched call's lanes step together,
    so its i-th cycle runs the longest lane's steps."""
    return sum(max(c[i] if i < len(c) else 0 for c in cycles)
               for i in range(max(len(c) for c in cycles)))


def _resolve(path: str):
    module, attr = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), attr)


@contextlib.contextmanager
def _timer(spans: dict, key: str, sync):
    """Add the seconds of the block, ended by ``sync()``, to ``spans[key]``."""
    t0 = time.perf_counter()
    yield
    sync()
    spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0


class Setup:
    """The cell's operator (its CSR arrays, kept for the reference), staged
    operator and preconditioner, and its entry point, made once;
    ``pool(seed)`` makes a pool of right-hand sides and ``call`` drives
    the entry point."""

    def __init__(self, cell: Cell, device, spans: dict):
        self.cell, self.device = cell, torch.device(device)
        cuda = self.device.type == "cuda"
        self.sync = torch.cuda.synchronize if cuda else (lambda: None)
        with _timer(spans, "program_import_s", self.sync):
            from gmres_tpu_torch import stage
            from gmres_tpu_torch.precond.build import build_preconditioner
            from gmres_tpu_torch.sparse import csr_from_arrays
            self.entry = _resolve(cell.traffic["entry"])
        conf, solver = cell.config, cell.config["solver"]
        if cuda:
            with _timer(spans, "kernel_load_s", self.sync):
                from gmres_tpu_torch.ops.cuda._build import host_library, library
                library()
                if solver["precond"] in ("ilu", "ilu_jacobi"):
                    host_library()
        with _timer(spans, "operator_s", self.sync):
            op = dict(conf["operator"])
            gen = generator(op.pop("generator"))
            self.csr = gen.build(**op)
            self.n = self.csr[0].shape[0] - 1
            self.diagonals = gen.diagonals(**op)
            A_csr = csr_from_arrays(*self.csr)
            self.A_host = inputs.csr_matrix(*self.csr)
        self.cfg = self.config_for(solver)
        with _timer(spans, "stage_s", self.sync):
            self.A = stage(A_csr, self.cfg, device=self.device)
        self.M = None
        if solver["precond"] != "identity":
            with _timer(spans, "precond_build_s", self.sync):
                self.M = build_preconditioner(A_csr, self.cfg).to(self.device)
        self.lanes = cell.traffic["rhs_per_call"]

    @staticmethod
    def config_for(solver: dict):
        """The program's GmresConfig of a configuration's ``solver``: its
        ``mode`` is a mode's name, or the dtypes {outer, inner, precond}."""
        from gmres_tpu_torch import GmresConfig, PrecisionSpec

        mode = solver["mode"]
        precision = (PrecisionSpec.from_mode(mode) if isinstance(mode, str)
                     else PrecisionSpec(mode["outer"], mode["inner"], mode["precond"]))
        return GmresConfig(precision=precision, orth=solver["orth"], precond=solver["precond"],
                           restart_length=solver["restart_length"], tol=solver["tol"],
                           max_restarts=solver["max_restarts"],
                           bf16_escalation=solver.get("bf16_escalation", True))

    def pool(self, seed: int) -> list:
        """The pool's right-hand sides, float64 on the device."""
        return [torch.from_numpy(self.A_host @ x).to(self.device)
                for x in inputs.x_trues(self.n, seed, self.cell.traffic["pool"])]

    def reference(self) -> Reference:
        """The plain reference of the operator, on the device."""
        return Reference(*self.csr, self.device)

    def call(self, B: list, idx: list, cfg=None, record_history: bool = False) -> list:
        """One call of the entry point on the pool's right-hand sides
        ``idx``, from x0 = 0; a GmresResult a right-hand side."""
        cfg = cfg or self.cfg
        if self.lanes == 1:
            return [self.entry(self.A, B[idx[0]], cfg, M=self.M, record_history=record_history,
                               device=self.device)]
        return self.entry(self.A, torch.stack([B[i] for i in idx]), cfg, M=self.M,
                          record_history=record_history, device=self.device)

    def free(self) -> None:
        """Drop the program's state (the staged operator and M)."""
        self.A = self.M = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reported(result) -> float | None:
    """The backward error a converged solve reported for its answer: its
    last restart check's, from its float64 outer residual (None where it
    did not converge)."""
    if not result.converged or not result.history:
        return None
    return result.history[-1].get("rel_initial")


def judge(reference: Reference, B: list, answers: list) -> list:
    """The numbers judged on each answer (pool index, x, reported backward
    error or None), by the name of the check that holds their worst."""
    out = []
    for i, x, said in answers:
        be = reference.backward_error(B[i], x)
        nums = {"worst_backward_error": be}
        if said is not None:
            nums["worst_reported_gap"] = (abs(said - be) / be if be > 0
                                          else (0.0 if said == 0 else math.inf))
        out.append(nums)
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return f"card {torch.cuda.get_device_name()} (nvidia-smi not found)"
    out = subprocess.run([smi, "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return f"card {out.stdout.strip()}"


def reader_path(name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, or where a
    quantity is split by the end-to-end metric it moves (``<base>.<part>``,
    no file of its own), its base's reader."""
    path = BENCH / "metrics" / f"{name}.py"
    return path if path.is_file() else BENCH / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, run: Run):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda",
             overrides: dict | None = None, t_start: float | None = None, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line's object.  Raises
    ``NoResult`` where the run may print none."""
    t_start = time.monotonic() if t_start is None else t_start
    cell = load_cell(workload, overrides)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips):
        raise NoResult(f"{workload} needs {cell.chips} CUDA device(s); torch sees "
                       f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    spans = {"import_s": time.monotonic() - t_start}
    if cuda:
        with _timer(spans, "cuda_init_s", torch.cuda.synchronize):
            torch.cuda.init()
            torch.empty(1, device=dev)
        with _timer(spans, "card_s", lambda: None):
            print(card_line(), flush=True)
    setup = Setup(cell, dev, spans)
    with _timer(spans, "pool_s", setup.sync):
        B = setup.pool(seed)
    lanes, size = setup.lanes, len(B)
    with _timer(spans, "warmup_s", setup.sync):
        setup.call(B, [j % size for j in range(lanes)], record_history=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        allocs0 = torch.cuda.memory_stats(dev).get("num_device_alloc")
    setup_s = time.monotonic() - t_start

    watch = HostWatch()
    calls, kept, pick, slots = [], [], random.Random(seed), max(1, KEEP_ANSWERS // lanes)
    copy_s, host0 = 0.0, watch.snapshot()
    t_open = time.perf_counter()
    while True:
        i = len(calls)
        idx = [(i * lanes + j) % size for j in range(lanes)]
        c0, t0 = time.thread_time(), time.perf_counter()
        results = setup.call(B, idx, record_history=True)
        t1, c1 = time.perf_counter(), time.thread_time()
        elapsed = t1 - t_open - copy_s
        calls.append({"iters": [r.total_iters for r in results],
                      "converged": [r.converged for r in results],
                      "steps": max(r.total_iters for r in results), "seconds": t1 - t0,
                      "cpu_s": c1 - c0})
        j = len(kept) if len(kept) < slots else pick.randrange(i + 1)
        if j < slots:
            item = (i, [(b, r.x.to("cpu"), reported(r)) for b, r in zip(idx, results)])
            kept[j:j + 1] = [item]
            copy_s += time.perf_counter() - t1
        if elapsed >= seconds:
            break
    window_s = elapsed
    host = {**delta(host0, watch.snapshot()), "mhz": clock_mhz()}
    watch.close()
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda and allocs0 is not None:
        host["device_allocs"] = torch.cuda.memory_stats(dev)["num_device_alloc"] - allocs0

    run = Run(cell.config, setup.n, setup.diagonals, spans, window_s, calls)
    if traced:
        res, run.events, traced_s = trace.profile_call(
            lambda: setup.call(B, [j % size for j in range(lanes)], record_history=True),
            dev, TRACE_DIR / f"{workload}.json")
        run.cycles = [[h["k"] for h in r.history] for r in res]

    setup.free()
    t_ref = time.perf_counter()
    reference = setup.reference()
    limits = cell.config["checks"]
    answers = [(i, lane, b, x, said) for i, xs in kept for lane, (b, x, said) in enumerate(xs)]
    numbers = judge(reference, B, [(b, x, said) for _, _, b, x, said in answers])
    reference_s = time.perf_counter() - t_ref
    bad = {(i, lane) for (i, lane, *_), nums in zip(answers, numbers)
           if any(not v <= limits[k] for k, v in nums.items() if k in limits)}
    bad |= {(i, lane) for i, c in enumerate(calls) for lane, ok in enumerate(c["converged"])
            if not ok}
    attempted = len(calls) * lanes
    values = {k: max((nums[k] for nums in numbers if k in nums), default=math.inf)
              for k in limits}
    values["unconverged"] = sum(not ok for c in calls for ok in c["converged"])
    correct = bool(numbers) and all(values.get(k, math.inf) <= v for k, v in limits.items())
    # JSON has no infinity: a NaN answer, or none judged, reads as the largest double
    checks = {k: {"value": min(values.get(k, math.inf), sys.float_info.max), "limit": v}
              for k, v in limits.items()}

    secs = sorted(c["seconds"] for c in calls)
    print(f"setup {json.dumps(spans)} setup_s {setup_s}", file=log)
    print(f"window {window_s} s, {len(calls)} calls, {attempted} right-hand sides, call seconds "
          f"min {secs[0]} median {secs[len(secs) // 2]} max {secs[-1]} in order "
          f"{[round(c['seconds'], 4) for c in calls]}, their main thread's CPU seconds "
          f"{[round(c['cpu_s'], 4) for c in calls]}, iters "
          f"{sorted({it for c in calls for it in c['iters']})}, judged {len(numbers)} in "
          f"{reference_s} s, kept answers copied to the host in {copy_s} s (not in the window)",
          file=log)
    print(f"host {json.dumps(host)}", file=log)

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = read_metric(m["name"], run)
            if value is None:
                print(f"metric {m['name']} found nothing to read; left out", file=log)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "solve_s": window_s / max(attempted - len(bad), 1)}
        # an end-to-end metric split by cells (``<base>.<part>``) is its base's quantity
        metrics = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    out = {"correct": correct, "attempted": attempted, "failed": len(bad), "metrics": metrics,
           "device": device_info}
    if traced:
        device_info["busy_s"] = trace.busy_us(run.events) * 1e-6
        device_info["window_s"] = traced_s
        out["breakdown"] = trace.breakdown(run.events)
    out["checks"] = checks
    return out


def emit(result: dict, log=sys.stderr) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output.  Refuses (NoResult) where a module
    of JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        raise NoResult(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    log.flush()
    print(json.dumps(result), flush=True)
