#!/usr/bin/env python3
"""On-card smoke run of gmres_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and
drives two paths, each through ``gmres_tpu_torch.stage`` and ``solve`` in
the ``baseline`` and ``mixed`` modes (x_true = rand_vect(n, 42), b = A x_true
in fp64 numpy, CGSR, identity preconditioner, restart length 30, tol 1e-8):

1. the banded path: ``convection_diffusion_2d(1024, beta=2.0)`` (n =
   1,048,576, 5 DIA bands), kernels K1-K4, the reference's 26/780 history;
2. the unstructured path: ``unstructured_mesh(1024*1024, run=8)`` (mesh3d,
   25,151,458 nonzeros, which DIA refuses), staged as SELL, kernels K5 and
   K2-K4, the reference's 1/30 history.

Before each path's solves it holds each of the path's kernels against its
plain PyTorch version at the path's shapes (fp32 and fp64; a 31-row Krylov
basis) and times both.  Each path's launch counts are reset just before its
solves and read just after: the path's own kernels must launch, the other
path's SpMV kernels must not.  Any failed check raises and the script exits
non-zero; without a CUDA device it exits non-zero at once.

Output: the card's name and power limit, versions, build time, per-kernel
error and timing lines, per-path build/stage and per-mode solve lines; then
one JSON line with the kernels (launch counts from the solves, measured
errors and times); then the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NX = 1024          # n = NX^2 = 1,048,576 rows, 5,238,784 nonzeros
RLEN = 30
TOL = 1e-8
MAX_RESTARTS = 80
TPU_ITERS = 780    # the reference's history on convdiff (BENCH_r05.json)
# the reference's history on mesh3d@1M (results/round5/bench_mesh3d.txt),
# both modes: (restarts, iterations)
MESH_TPU_HISTORY = (1, 30)
REPS = 20          # timed launches per kernel and per plain version
# the kernels each path's SpMV runs; K2-K4 (the basis sweeps and the update)
# serve both paths
PATH_KERNELS = {"convdiff": ("dia_spmv", "dia_residual"),
                "mesh3d": ("sell_spmv", "sell_residual")}
# Kernel vs plain tolerance, relative to the same computation on absolute
# values (the scale of the standard summation error bound): the two sum in
# different orders (per-block partials, FMA contraction) over up to n terms.
TOL_REL = {"float32": 1e-5, "float64": 1e-13}


def log(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def device_lines():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return smi


def nvcc_version():
    from gmres_tpu_torch.ops.cuda._build import _nvcc

    out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    return out[-1] if out else "?"


class Timer:
    """Median device time of a callable, one CUDA-event pair per launch,
    with the 50 MB L2 flushed before each launch (the main path streams the
    basis through L2 between two calls of any kernel)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps=REPS):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def copy_bandwidth(torch):
    nbytes = 256 * 1024 * 1024
    src = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    ms = Timer(torch)(lambda: dst.copy_(src))
    return ms, 2 * nbytes / (ms * 1e-3) / 1e9


def compare(dtype, got, want, scale):
    """Max abs error of `got` against `want`, and whether it is within the
    tolerance relative to `scale`."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    bound = max(TOL_REL[dtype] * float(s.abs().max()) for s in scale)
    ok = err <= bound
    return err, bound, ok


class Records:
    """Per-kernel, per-dtype error and timing records for the JSON line."""

    def __init__(self, copy_gbs):
        self.copy_gbs = copy_gbs
        self.records = {}
        self.failures = []

    def __call__(self, kname, dtype, err, bound, ok, ms, plain_ms, nbytes):
        gbs = nbytes / (ms * 1e-3) / 1e9
        log(f"kernel {kname:<18} {dtype:<8} max_abs_err={err:.3e} (tol {bound:.3e}) "
            f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms ({gbs:.1f} GB/s, "
            f"{gbs / self.copy_gbs:.2f} of copy)  plain {plain_ms:.4f} ms")
        if not ok:
            self.failures.append(f"{kname} {dtype}")
        self.records.setdefault(kname, {})[dtype] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, gb_per_s=gbs)

    def require_ok(self):
        require(not self.failures,
                f"kernels disagree with their plain versions: {self.failures}")


def check_residual(torch, record, kname, dt, dt_name, timer, fn_cuda, fn_plain, scale_r,
                   nbytes):
    """A residual mode (fp64 operator, norm of r demoted to dt) against its
    plain version: r within the fp64 tolerance of |b| + |A||x|, the sums of
    squares (fp64 accumulation against the plain version's accumulation in
    the inner dtype) within 1e-5 (fp32) or 1e-12 (fp64) relative."""
    got, want = fn_cuda(), fn_plain()
    err_r, bound_r, ok_r = compare("float64", got[:1], want[:1], [scale_r])
    ss_err = max(abs(float(g - w_)) / float(w_) for g, w_ in zip(got[1:], want[1:]))
    ss_tol = 1e-5 if dt == torch.float32 else 1e-12
    log(f"  {kname}[{dt_name} norm] sums of squares rel err {ss_err:.3e} (tol {ss_tol:.0e})")
    record(kname, dt_name, err_r, bound_r, ok_r and ss_err <= ss_tol,
           timer(fn_cuda), timer(fn_plain), nbytes)


def check_kernels(torch, A_csr, record):
    """K1-K4 against their plain versions at the banded path's shapes."""
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_, outer_kernel as ou, spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import from_csr

    dia = from_csr(A_csr)
    require(dia is not None and len(dia.offsets) == 5, "convdiff repacks to 5 DIA bands")
    n = dia.n_rows
    m1 = RLEN + 1
    rng = np.random.default_rng(0)
    timer = Timer(torch)

    x_np = rng.random(n)
    b_np = rng.standard_normal(n)
    V_np = rng.standard_normal((m1, n)) / np.sqrt(n)
    w_np = rng.standard_normal(n)
    u_np = rng.standard_normal(m1)

    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        s = dt.itemsize
        data = dia.data.to("cuda", dt)
        offs = dia.offsets
        D = len(offs)
        x = torch.tensor(x_np, dtype=dt, device="cuda")
        V = torch.tensor(V_np, dtype=dt, device="cuda")
        w = torch.tensor(w_np, dtype=dt, device="cuda")
        u = torch.tensor(u_np, dtype=dt, device="cuda")

        # K1 plain mode
        got = sk.dia_spmv_cuda(data, offs, x)
        want = sk.dia_spmv_plain(data, offs, x)
        scale = sk.dia_spmv_plain(data.abs(), offs, x.abs())
        record("dia_spmv", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: sk.dia_spmv_cuda(data, offs, x)),
               timer(lambda: sk.dia_spmv_plain(data, offs, x)), (D + 2) * n * s)

        # K1 residual mode: outer dtype fp64; the norm of r demoted to the
        # inner dtype dt (mixed: fp32, baseline: fp64)
        d64 = dia.data.to("cuda", torch.float64)
        x64 = torch.tensor(x_np, dtype=torch.float64, device="cuda")
        b64 = torch.tensor(b_np, dtype=torch.float64, device="cuda")
        check_residual(torch, record, "dia_residual", dt, dt_name, timer,
                       lambda: sk.dia_residual_cuda(d64, offs, b64, x64, dt),
                       lambda: sk.dia_residual_plain(d64, offs, b64, x64, dt),
                       b64.abs() + sk.dia_spmv_plain(d64.abs(), offs, x64), (D + 3) * n * 8)

        # K2 gram over all m+1 rows (the last Arnoldi step)
        got = ok_.gram_cuda(V, w, m1)
        want = ok_.gram_plain(V, w, m1)
        scale = ok_.gram_plain(V.abs(), w.abs(), m1)
        record("basis_gram", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: ok_.gram_cuda(V, w, m1)),
               timer(lambda: ok_.gram_plain(V, w, m1)), (m1 + 1) * n * s)

        # K3 update + gram
        got = ok_.update_gram_cuda(V, w, u, m1)
        want = ok_.update_gram_plain(V, w, u, m1)
        sw = w.abs() + torch.mv(V.abs().t(), u.abs())
        scale = [sw, ok_.gram_plain(V.abs(), sw, m1)]
        record("basis_update_gram", dt_name,
               *compare(dt_name, got, want, scale),
               timer(lambda: ok_.update_gram_cuda(V, w, u, m1)),
               timer(lambda: ok_.update_gram_plain(V, w, u, m1)), (m1 + 2) * n * s)

        # K3 update + sum of squares
        got = ok_.update_sumsq_cuda(V, w, u, m1)
        want = ok_.update_sumsq_plain(V, w, u, m1)
        scale = [sw, torch.dot(sw, sw)]
        record("basis_update_sumsq", dt_name,
               *compare(dt_name, got, want, scale),
               timer(lambda: ok_.update_sumsq_cuda(V, w, u, m1)),
               timer(lambda: ok_.update_sumsq_plain(V, w, u, m1)), (m1 + 2) * n * s)

        # K4: x (fp64) += y^T V[:m]
        y = u[:RLEN].contiguous()
        got = ou.basis_axpy_cuda(x64.clone(), V, y)
        want = ou.basis_axpy_plain(x64.clone(), V, y)
        scale = ou.basis_axpy_plain(x64.abs(), V.abs(), y.abs())
        xk, xp = x64.clone(), x64.clone()
        record("basis_axpy", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: ou.basis_axpy_cuda(xk, V, y)),
               timer(lambda: ou.basis_axpy_plain(xp, V, y)), RLEN * n * s + 2 * n * 8)
        torch.cuda.synchronize()
        del data, x, V, w, u, d64, x64, b64
    record.require_ok()


def check_sell_kernels(torch, S, record):
    """K5 in plain mode (fp32, fp64) and residual mode (fp64 operator, fp32
    and fp64 norm) against its plain versions on the staged operator."""
    from gmres_tpu_torch.ops.cuda import sell_kernel as sl

    n, n_slots = S.n_rows, S.n_slots
    rng = np.random.default_rng(1)
    timer = Timer(torch)
    x_np = rng.random(n)
    b64 = torch.tensor(rng.standard_normal(n), dtype=torch.float64, device="cuda")
    x64 = torch.tensor(x_np, dtype=torch.float64, device="cuda")
    v64, cols, sp = S.vals, S.cols, S.slice_ptr
    for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        s = dt.itemsize
        vals = v64.to(dt)
        x = x64.to(dt)
        got = sl.sell_spmv_cuda(vals, cols, sp, x, n)
        want = sl.sell_spmv_plain(vals, cols, sp, x, n)
        scale = sl.sell_spmv_plain(vals.abs(), cols, sp, x.abs(), n)
        # bytes: each slot's value and int32 column, x once, y
        record("sell_spmv", dt_name, *compare(dt_name, [got], [want], [scale]),
               timer(lambda: sl.sell_spmv_cuda(vals, cols, sp, x, n)),
               timer(lambda: sl.sell_spmv_plain(vals, cols, sp, x, n)),
               n_slots * (s + 4) + 2 * n * s)
        check_residual(torch, record, "sell_residual", dt, dt_name, timer,
                       lambda: sl.sell_residual_cuda(v64, cols, sp, b64, x64, dt),
                       lambda: sl.sell_residual_plain(v64, cols, sp, b64, x64, dt),
                       b64.abs() + sl.sell_spmv_plain(v64.abs(), cols, sp, x64, n),
                       n_slots * 12 + 3 * n * 8)
        torch.cuda.synchronize()
        del vals, x, got, want, scale
    record.require_ok()


def csr_residual(A_csr, x, b):
    """b - A x in fp64 numpy, independent of the port's kernels."""
    rp, ci, v = A_csr.numpy_arrays()
    rows = np.repeat(np.arange(A_csr.n_rows), np.diff(rp))
    return b - np.bincount(rows, weights=v * x[ci], minlength=A_csr.n_rows)


def run_main_path(torch, label, A_csr, A_dev, expect):
    """Solve the path's problem in both modes on the staged operator; hold
    each mode to its expected history (`expect(restarts, iters)` returns the
    failure text or None) and to a backward error <= 1e-8 recomputed here
    in fp64; return the launch counts of the path's solves."""
    from gmres_tpu_torch import GmresConfig, PrecisionSpec, rand_vect, solve
    from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    n = A_csr.n_rows
    x_true = rand_vect(n, 42)
    b = -csr_residual(A_csr, x_true, np.zeros(n))
    a_fro = float(np.linalg.norm(A_csr.vals.numpy()))
    b_norm = float(np.linalg.norm(b))
    b_dev = torch.tensor(b, device="cuda")
    other = {k for path, ks in PATH_KERNELS.items() if path != label for k in ks}

    walls = {}
    reset_launch_counts()
    for mode in ("baseline", "mixed"):
        cfg = GmresConfig(precision=PrecisionSpec.from_mode(mode), orth="cgsr",
                          precond="identity", restart_length=RLEN, tol=TOL,
                          max_restarts=MAX_RESTARTS)
        before = launch_counts()
        res = solve(A_dev, b_dev, cfg)  # warm-up
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = solve(A_dev, b_dev, cfg)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        after = launch_counts()
        counts = {k: after[k] - before[k] for k in after}
        x = res.x.cpu().numpy()
        r = csr_residual(A_csr, x, b)
        backward = float(np.linalg.norm(r) / (b_norm + a_fro * np.linalg.norm(x)))
        err = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
        wall = statistics.median(times)
        walls[mode] = wall
        log(f"solve {label} {mode}: converged={res.converged} restarts={res.restarts} "
            f"total_iters={res.total_iters} wall median={wall:.4f} s "
            f"walls={[round(t, 4) for t in times]} backward_err={backward:.3e} "
            f"rel_fwd_err={err:.3e}")
        log(f"  launches {label} {mode}: {counts}")
        require(res.converged, f"{label} {mode} converged")
        require(backward <= 1e-8, f"{label} {mode} backward error {backward:.3e} <= 1e-8")
        bad = expect(res.restarts, res.total_iters)
        require(bad is None, f"{label} {mode}: {bad}")
        require(all(v > 0 for k, v in counts.items() if k not in other),
                f"{label} {mode}: every kernel of the path launched ({counts})")
        require(all(counts[k] == 0 for k in other),
                f"{label} {mode}: no other path's SpMV kernel launched ({counts})")
        require(np.all(np.isfinite(x)) and x.shape == (n,),
                f"{label} {mode} x finite, shape ({n},)")
    log(f"{label} mixed/baseline wall ratio: {walls['mixed'] / walls['baseline']:.4f} "
        f"(baseline/mixed speedup {walls['baseline'] / walls['mixed']:.4f})")
    return launch_counts()


def stage_timed(torch, A_csr):
    from gmres_tpu_torch import stage

    t0 = time.perf_counter()
    A_dev = stage(A_csr)
    torch.cuda.synchronize()
    return A_dev, time.perf_counter() - t0


def convdiff_path(torch, record):
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.dia import DIAMatrix

    t0 = time.perf_counter()
    A = convection_diffusion_2d(NX, beta=2.0)
    log(f"matrix: convection_diffusion_2d({NX}, beta=2.0) n={A.n_rows:,} "
        f"nnz={A.nnz:,} built in {time.perf_counter() - t0:.2f} s")
    check_kernels(torch, A, record)
    A_dev, secs = stage_timed(torch, A)
    require(isinstance(A_dev, DIAMatrix), f"convdiff stages as DIA, got {type(A_dev).__name__}")
    log(f"stage: {type(A_dev).__name__} offsets={A_dev.offsets} on {A_dev.device} "
        f"in {secs:.3f} s")

    def expect(restarts, iters):
        log(f"  convdiff history vs TPU reference {TPU_ITERS}: diff {iters - TPU_ITERS:+d}")
        if abs(iters - TPU_ITERS) > RLEN:
            return f"total_iters {iters} not within {RLEN} of {TPU_ITERS}"
        return None

    return run_main_path(torch, "convdiff", A, A_dev, expect)


def mesh3d_path(torch, record):
    from gmres_tpu_torch.io.synth import unstructured_mesh
    from gmres_tpu_torch.ops.sell import SELLMatrix

    t0 = time.perf_counter()
    A = unstructured_mesh(NX * NX, run=8)
    log(f"matrix: unstructured_mesh({NX * NX}, run=8) n={A.n_rows:,} nnz={A.nnz:,} "
        f"built in {time.perf_counter() - t0:.2f} s")
    A_dev, secs = stage_timed(torch, A)
    require(isinstance(A_dev, SELLMatrix), f"mesh3d stages as SELL, got {type(A_dev).__name__}")
    widths = (torch.diff(A_dev.slice_ptr) // 32).cpu().numpy()
    log(f"stage: {type(A_dev).__name__} (pack + upload) in {secs:.3f} s: "
        f"{A_dev.n_slots:,} slots for {A_dev.nnz:,} nonzeros, padding ratio "
        f"{A_dev.padding:.6f}, slice widths {int(widths.min())}..{int(widths.max())}")
    check_sell_kernels(torch, A_dev, record)

    def expect(restarts, iters):
        if (restarts, iters) != MESH_TPU_HISTORY:
            return f"history {restarts}/{iters}, the TPU reference's is {MESH_TPU_HISTORY}"
        return None

    return run_main_path(torch, "mesh3d", A, A_dev, expect)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 reference products

    from gmres_tpu_torch.ops.cuda import kernel_wrappers
    from gmres_tpu_torch.ops.cuda._build import library

    for line in device_lines():
        log(line)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"nvcc: {nvcc_version()}")

    t0 = time.perf_counter()
    lib = library()
    log(f"kernel build+load: {time.perf_counter() - t0:.3f} s ({lib.path.name} in "
        f"{lib.path.parent})")
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    copy_ms, copy_gbs = copy_bandwidth(torch)
    log(f"yardstick: torch device copy of 256 MB: {copy_ms:.4f} ms, {copy_gbs:.1f} GB/s")
    record = Records(copy_gbs)
    path_counts = [convdiff_path(torch, record), mesh3d_path(torch, record)]
    counts = {k: sum(c[k] for c in path_counts) for k in kernel_wrappers()}
    require(all(v > 0 for v in counts.values()), f"every kernel launched on some path ({counts})")
    records = record.records

    # kernel -> (source, the TPU kernels' pallas_calls it replaces); the
    # JSON numbers are the fp32 variant (the mixed inner loop; for the
    # residual modes the fp64 residual with its fp32-demoted norm), fp64
    # alongside; launches are summed over the two paths' solves
    sources = {
        "dia_spmv": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                     "gmres_tpu/ops/pallas/spmv_kernel.py:88"),
        "dia_residual": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                         "gmres_tpu/ops/pallas/df64_kernel.py:243"),
        "sell_spmv": ("gmres_tpu_torch/csrc/sell_spmv.cu",
                      "gmres_tpu/ops/pallas/sell_kernel.py:272,218"),
        "sell_residual": ("gmres_tpu_torch/csrc/sell_spmv.cu",
                          "gmres_tpu/ops/pallas/sell_kernel.py:452,490"),
        "basis_gram": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                       "gmres_tpu/ops/pallas/orth_kernel.py:59"),
        "basis_update_gram": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                              "gmres_tpu/ops/pallas/orth_kernel.py:171"),
        "basis_update_sumsq": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                               "gmres_tpu/ops/pallas/orth_kernel.py:216"),
        "basis_axpy": ("gmres_tpu_torch/csrc/basis_sweep.cu",
                       "gmres_tpu/ops/pallas/df64_kernel.py:295"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "dtype": "float32",
            "max_abs_err": rec["float32"]["max_abs_err"], "ms": rec["float32"]["ms"],
            "plain_ms": rec["float32"]["plain_ms"], "gb_per_s": rec["float32"]["gb_per_s"],
            "float64": rec["float64"], "copy_gb_per_s": copy_gbs,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
