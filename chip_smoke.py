#!/usr/bin/env python3
"""On-card smoke run of gmres_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version at the shapes of the main path
(n = 1,048,576 rows, 5 bands, a 31-row Krylov basis, fp32 and fp64) and
times both, then solves the benchmark problem (``convection_diffusion_2d(1024,
beta=2.0)``, x_true = rand_vect(n, 42), CGSR, identity preconditioner,
restart length 30, tol 1e-8) in the ``baseline`` and ``mixed`` modes through
``gmres_tpu_torch.stage`` and ``solve``.  Any failed check raises and the
script exits non-zero; without a CUDA device it exits non-zero at once.

Output: the card's name and power limit, versions, build time, per-kernel
error and timing lines, per-mode solve lines; then one JSON line with the
kernels (launch counts from the solves, measured errors and times); then
the last line ``{"ok": true, "device": {...}}``.
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
TPU_ITERS = 780    # the reference's history on this problem (BENCH_r05.json)
REPS = 20          # timed launches per kernel and per plain version
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


def check_kernels(torch, A_csr):
    """Every kernel against its plain version at main-path shapes; returns
    the per-kernel records for the JSON line."""
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok_, outer_kernel as ou, spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import from_csr

    dia = from_csr(A_csr)
    require(dia is not None and len(dia.offsets) == 5, "convdiff repacks to 5 DIA bands")
    n = dia.n_rows
    m1 = RLEN + 1
    rng = np.random.default_rng(0)
    timer = Timer(torch)
    copy_ms, copy_gbs = copy_bandwidth(torch)
    log(f"yardstick: torch device copy of 256 MB: {copy_ms:.4f} ms, {copy_gbs:.1f} GB/s")

    x_np = rng.random(n)
    b_np = rng.standard_normal(n)
    V_np = rng.standard_normal((m1, n)) / np.sqrt(n)
    w_np = rng.standard_normal(n)
    u_np = rng.standard_normal(m1)
    records = {}
    failures = []

    def record(kname, dtype, err, bound, ok, ms, plain_ms, nbytes):
        gbs = nbytes / (ms * 1e-3) / 1e9
        log(f"kernel {kname:<18} {dtype:<8} max_abs_err={err:.3e} (tol {bound:.3e}) "
            f"{'ok' if ok else 'FAIL'}  kernel {ms:.4f} ms ({gbs:.1f} GB/s, "
            f"{gbs / copy_gbs:.2f} of copy)  plain {plain_ms:.4f} ms")
        if not ok:
            failures.append(f"{kname} {dtype}")
        records.setdefault(kname, {})[dtype] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, gb_per_s=gbs)

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
        got = sk.dia_residual_cuda(d64, offs, b64, x64, dt)
        want = sk.dia_residual_plain(d64, offs, b64, x64, dt)
        scale_r = b64.abs() + sk.dia_spmv_plain(d64.abs(), offs, x64)
        err_r, bound_r, ok_r = compare("float64", got[:1], want[:1], [scale_r])
        # the sums of squares: fp64 accumulation against the plain version's
        # accumulation in the inner dtype
        ss_err = max(abs(float(g - w_)) / float(w_) for g, w_ in zip(got[1:], want[1:]))
        ss_tol = 1e-5 if dt == torch.float32 else 1e-12
        log(f"  dia_residual[{dt_name} norm] sums of squares rel err {ss_err:.3e} (tol {ss_tol:.0e})")
        record("dia_residual", dt_name, err_r, bound_r, ok_r and ss_err <= ss_tol,
               timer(lambda: sk.dia_residual_cuda(d64, offs, b64, x64, dt)),
               timer(lambda: sk.dia_residual_plain(d64, offs, b64, x64, dt)),
               (D + 3) * n * 8)

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
    require(not failures, f"kernels disagree with their plain versions: {failures}")
    return records, copy_gbs


def csr_residual(A_csr, x, b):
    """b - A x in fp64 numpy, independent of the port's kernels."""
    rp, ci, v = A_csr.numpy_arrays()
    rows = np.repeat(np.arange(A_csr.n_rows), np.diff(rp))
    return b - np.bincount(rows, weights=v * x[ci], minlength=A_csr.n_rows)


def run_main_path(torch, A_csr):
    from gmres_tpu_torch import GmresConfig, PrecisionSpec, rand_vect, solve, stage
    from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    n = A_csr.n_rows
    x_true = rand_vect(n, 42)
    b = -csr_residual(A_csr, x_true, np.zeros(n))
    a_fro = float(np.linalg.norm(A_csr.vals.numpy()))
    b_norm = float(np.linalg.norm(b))

    t0 = time.perf_counter()
    A_dev = stage(A_csr)
    torch.cuda.synchronize()
    log(f"stage: {type(A_dev).__name__} offsets={A_dev.offsets} on {A_dev.device} "
        f"in {time.perf_counter() - t0:.3f} s")
    b_dev = torch.tensor(b, device="cuda")

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
        log(f"solve {mode}: converged={res.converged} restarts={res.restarts} "
            f"total_iters={res.total_iters} (TPU reference {TPU_ITERS}, diff "
            f"{res.total_iters - TPU_ITERS:+d}) wall median={wall:.4f} s "
            f"walls={[round(t, 4) for t in times]} backward_err={backward:.3e} "
            f"rel_fwd_err={err:.3e}")
        log(f"  launches {mode}: {counts}")
        require(res.converged, f"{mode} converged")
        require(backward <= 1e-8, f"{mode} backward error {backward:.3e} <= 1e-8")
        require(abs(res.total_iters - TPU_ITERS) <= RLEN,
                f"{mode} total_iters {res.total_iters} within {RLEN} of {TPU_ITERS}")
        require(all(v > 0 for v in counts.values()),
                f"{mode}: every kernel launched ({counts})")
        require(np.all(np.isfinite(x)) and x.shape == (n,), f"{mode} x finite, shape ({n},)")
    totals = launch_counts()
    log(f"mixed/baseline wall ratio: {walls['mixed'] / walls['baseline']:.4f} "
        f"(baseline/mixed speedup {walls['baseline'] / walls['mixed']:.4f})")
    return totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False  # full-fp32 reference products

    from gmres_tpu_torch.io.synth import convection_diffusion_2d
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

    t0 = time.perf_counter()
    A = convection_diffusion_2d(NX, beta=2.0)
    log(f"matrix: convection_diffusion_2d({NX}, beta=2.0) n={A.n_rows:,} "
        f"nnz={A.nnz:,} built in {time.perf_counter() - t0:.2f} s")

    records, copy_gbs = check_kernels(torch, A)
    counts = run_main_path(torch, A)

    # kernel -> (source, the TPU kernel's pallas_call it replaces); the JSON
    # numbers are the fp32 variant (the mixed inner loop; for dia_residual
    # the fp64 residual with its fp32-demoted norm), fp64 alongside
    sources = {
        "dia_spmv": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                     "gmres_tpu/ops/pallas/spmv_kernel.py:88"),
        "dia_residual": ("gmres_tpu_torch/csrc/dia_spmv.cu",
                         "gmres_tpu/ops/pallas/df64_kernel.py:243"),
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
