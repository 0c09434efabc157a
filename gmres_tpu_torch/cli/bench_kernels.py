"""Kernel microbenchmark, the reference's ``kernel_perf_test``
(``kernel_perf_test.cpp``: spmv, dot, the dot+axpy "MGS proxy", gemv) and
``gmres_tpu/cli/bench_kernels.py``: nnz/s and GB/s of the port's kernels on
one device.

    python -m gmres_tpu_torch.cli.bench_kernels --synth convdiff:1024 --json

The flags and JSON keys are the JAX package's where the operation exists;
``--device`` is ``cuda`` (the default) or ``cpu`` (the kernels' plain
versions), and ``--lanes`` the batch of K1's lane form.  Each operation is
timed by ``utils.profiling.seconds_per_call``: CUDA events around a loop of
``--trials`` calls, the card spinning while the host enqueues them, so
that the events hold device time.  Like the reference, which evicts the caches between
trials, the loop cycles through enough copies of the operands that each
call finds them outside the card's L2 cache.  The rows:

- ``spmv_dia_<dt>``: K1 (fp64, fp32; bf16 is the port's torch formula, K1
  has no bf16 form); ``spmv_sell_<dt>``: K5 (fp32, fp64) where the sliced
  ELL packer takes the matrix; ``spmv_csr_<dt>``: ``torch.sparse.mm``, a
  library call the port never makes (``"library": true``), beside which the
  kernels are read.  GB/s counts the reference's bytes, nnz (value + int32
  column) + x + y, for every format;
- ``spmv_dia_lanes<L>_<dt>``: K1's lane form over L lanes, nnz/s of all
  lanes, GB/s of the matrix once and x and y per lane;
- ``dot_<dt>``; ``dot_axpy_<dt>``, the MGS proxy (``torch.dot`` and an
  axpy, as the distributed MGS row loop runs it);
- ``gemv2_<dt>``: the CGS step over ``--vcols`` rows, K2 then K3's plain
  mode;
- ``gram_<dt>``, ``update_gram_<dt>``, ``update_sumsq_<dt>``: K2, K3 GRAM
  and K3 SUMSQ alone over ``--vcols`` rows, GB/s of the basis and the
  vectors once;
- ``cgsr2_pallas_<dt>``: the CGSR step (K2, K3 GRAM, K3 SUMSQ; the key of
  the JAX package's fused Pallas step), fp32 and fp64;
  ``cgsr2_pallas_cb_bf16V``: its compressed-basis form, a bf16 basis
  against fp32 vectors.

Not carried: the JAX package's jitted device loops and its cap on a loop's
device seconds, both for the TPU, and its ``dot_f64_strict`` row (the
port's fp64 dot is the strict one).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _copies(nbytes: int, dev) -> int:
    """Copies of a call's operands that a loop cycles through so that each
    call reads them from device memory: twice the L2 cache in all, at most
    8; one on the CPU."""
    import torch

    if dev.type != "cuda":
        return 1
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    return max(1, min(8, -(-2 * l2 // max(nbytes, 1))))


def _timed(make, nbytes: int, trials: int, dev) -> float:
    """Seconds a call, over a loop cycling through the calls ``make()``
    returns (one a copy of the operands)."""
    from gmres_tpu_torch.utils.profiling import seconds_per_call

    calls = [make() for _ in range(_copies(nbytes, dev))]
    state = {"i": 0}

    def step():
        calls[state["i"] % len(calls)]()
        state["i"] += 1

    return seconds_per_call(step, trials, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gmres-bench-kernels")
    ap.add_argument("--Apath", default=None)
    ap.add_argument("--synth", default="convdiff:1024")
    ap.add_argument("--vcols", type=int, default=31, help="basis width for gemv")
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--rand", type=int, default=42)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--lanes", type=int, default=8, help="lanes of K1's lane form")
    ap.add_argument("--reorder", choices=["rcm"], default=None,
                    help="apply a bandwidth-reducing RCM permutation before "
                         "format dispatch")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gmres_tpu_torch.cli.solve import make_synth
    from gmres_tpu_torch.io.loader import load_matrix
    from gmres_tpu_torch.io.rng import rand_vect
    from gmres_tpu_torch.ops.cuda.orth_kernel import (
        cgsr2,
        gram,
        update,
        update_gram,
        update_sumsq,
    )
    from gmres_tpu_torch.ops.dia import dia_spmv, dia_spmv_lanes, from_csr
    from gmres_tpu_torch.ops.sell import sell_from_csr, sell_spmv
    from gmres_tpu_torch.solver.gmres import resolve_device

    dev = resolve_device(args.device)
    A64 = make_synth(args.synth) if args.synth and not args.Apath else load_matrix(args.Apath)
    if args.reorder == "rcm":
        from gmres_tpu_torch.ops.reorder import permute_symmetric, rcm_permutation

        t0 = time.perf_counter()
        A64 = permute_symmetric(A64, rcm_permutation(A64))
        print(f"RCM reorder applied ({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    n, nnz = A64.n_rows, A64.nnz
    trials = args.trials
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"matrix: n={n:,} nnz={nnz:,}; trials={trials}; device {name}", file=sys.stderr)
    x64 = torch.tensor(rand_vect(n, args.rand), device=dev)
    results = {}

    def report(key, t, label, **extra):
        results[key] = dict(seconds=t, **extra)
        rates = "".join(f"  {v:.3e} nnz/s" if k == "nnz_per_s" else
                        f"  {v:7.1f} GB/s" if k == "gb_per_s" else ""
                        for k, v in extra.items())
        print(f"{label}: {t * 1e6:8.1f} us{rates}", file=sys.stderr)

    dia = from_csr(A64)
    sell = sell_from_csr(A64)
    rp, ci, v = A64.numpy_arrays()
    formats = [("csr", None)] + ([("dia", dia.to(dev))] if dia is not None else []) + (
        [("sell", sell.to(dev))] if sell is not None else [])
    for fmt, A0 in formats:
        for dt_name, dt in (("f64", torch.float64), ("f32", torch.float32),
                            ("bf16", torch.bfloat16)):
            if fmt == "sell" and dt == torch.bfloat16:
                continue   # K5 has no bf16 form; the port keeps a bf16 operator CSR
            itemsize = dt.itemsize
            nbytes = nnz * (itemsize + 4) + n * 2 * itemsize   # vals + cols + x + y
            if fmt == "csr":
                def make(dt=dt):
                    Acsr = torch.sparse_csr_tensor(
                        torch.tensor(rp.astype(np.int32), device=dev),
                        torch.tensor(ci[:nnz].astype(np.int32), device=dev),
                        torch.tensor(v[:nnz], device=dev).to(dt), size=(n, n),
                        check_invariants=False)
                    xd = x64.to(dt)[:, None]
                    return lambda: torch.sparse.mm(Acsr, xd)
            else:
                fn = dia_spmv if fmt == "dia" else sell_spmv

                def make(A0=A0, dt=dt, fn=fn):
                    A, xd = A0.astype(dt), x64.to(dt)
                    return lambda: fn(A, xd)
            try:
                t = _timed(make, nbytes, trials, dev)
            except (RuntimeError, NotImplementedError) as e:
                print(f"spmv {fmt} {dt_name}: FAILED ({type(e).__name__}: {str(e)[:120]})",
                      file=sys.stderr)
                continue
            extra = {"library": True} if fmt == "csr" else {}
            report(f"spmv_{fmt}_{dt_name}", t, f"spmv {fmt} {dt_name}", nnz_per_s=nnz / t,
                   gb_per_s=nbytes / t / 1e9, **extra)

    if dia is not None:
        lanes = args.lanes
        rng = np.random.default_rng(args.rand)
        for dt_name, dt in (("f64", torch.float64), ("f32", torch.float32)):
            itemsize = dt.itemsize
            nbytes = nnz * (itemsize + 4) + lanes * n * 2 * itemsize

            def make(dt=dt):
                A = dia.to(dev).astype(dt)
                X = torch.tensor(rng.standard_normal((lanes, n)), dtype=dt, device=dev)
                return lambda: dia_spmv_lanes(A, X)
            t = _timed(make, nbytes, trials, dev)
            report(f"spmv_dia_lanes{lanes}_{dt_name}", t, f"spmv dia lanes={lanes} {dt_name}",
                   nnz_per_s=lanes * nnz / t, gb_per_s=nbytes / t / 1e9)

    rng = np.random.default_rng(args.rand + 1)
    m = args.vcols
    for dt_name, dt in (("f64", torch.float64), ("f32", torch.float32)):
        itemsize = dt.itemsize

        def vectors(dt=dt):
            return (x64.to(dt), torch.tensor(0.5 * rand_vect(n, args.rand + 1), dtype=dt,
                                             device=dev))

        def make_dot():
            xd, y = vectors()
            return lambda: torch.dot(xd, y)
        t = _timed(make_dot, 2 * n * itemsize, trials, dev)
        report(f"dot_{dt_name}", t, f"dot  {dt_name}", gb_per_s=2 * n * itemsize / t / 1e9)

        def make_mgs():
            w, y = vectors()
            return lambda: w - torch.dot(w, y) * y
        t = _timed(make_mgs, 3 * n * itemsize, trials, dev)
        report(f"dot_axpy_{dt_name}", t, f"mgs  {dt_name}")

        def basis(dt=dt, vdt=None):
            V = torch.tensor(rng.standard_normal((m, n)) / np.sqrt(n), dtype=vdt or dt,
                             device=dev)
            return V, torch.tensor(rng.standard_normal(n), dtype=dt, device=dev)

        def make_cgs():
            V, w = basis()
            return lambda: update(V, w, gram(V, w, m), m)
        nbytes = 2 * m * n * itemsize
        t = _timed(make_cgs, nbytes, trials, dev)
        report(f"gemv2_{dt_name}", t, f"cgs  {dt_name} (m={m})", gb_per_s=nbytes / t / 1e9)

        # the three sweeps of the CGSR step alone: K2, K3 GRAM, K3 SUMSQ
        for key, label, sweep, rows in (
                ("gram", "K2 gram", lambda V, w, u: gram(V, w, m), m + 1),
                ("update_gram", "K3 update+gram", lambda V, w, u: update_gram(V, w, u, m),
                 m + 2),
                ("update_sumsq", "K3 update+sumsq", lambda V, w, u: update_sumsq(V, w, u, m),
                 m + 2)):
            def make_sweep(sweep=sweep):
                V, w = basis()
                u = torch.tensor(rng.standard_normal(m), dtype=dt, device=dev)
                return lambda: sweep(V, w, u)
            nbytes = rows * n * itemsize
            t = _timed(make_sweep, nbytes, trials, dev)
            report(f"{key}_{dt_name}", t, f"{label} {dt_name} (m={m})",
                   gb_per_s=nbytes / t / 1e9)

        def make_cgsr():
            V, w = basis()
            return lambda: cgsr2(V, w, m)
        nbytes = 3 * m * n * itemsize
        t = _timed(make_cgsr, nbytes, trials, dev)
        report(f"cgsr2_pallas_{dt_name}", t, f"cgsr2 {dt_name}", gb_per_s=nbytes / t / 1e9)

        if dt == torch.float32:
            # the compressed basis: V stored in bf16 against fp32 vectors
            def make_cb():
                V, w = basis(vdt=torch.bfloat16)
                return lambda: cgsr2(V, w, m)
            nbytes = 3 * m * n * 2
            t = _timed(make_cb, nbytes, trials, dev)
            report("cgsr2_pallas_cb_bf16V", t, "cgsr2 cb(bf16 V)", gb_per_s=nbytes / t / 1e9)

    if args.json:
        print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
