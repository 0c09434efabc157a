#!/usr/bin/env python3
"""condest of the port against the JAX package's, on the CPU, on the
mesh3d matrix (``unstructured_mesh(n, run=8)``, the pattern of
``--synth mesh3d:N``).  Routes (``--routes``, comma-separated):

- ``port``: the port (fp64 sliced ELL, plain versions);
- ``jax``: the JAX package's fp64 CSR route;
- ``extended``: a plain numpy implementation of the same protocol whose
  LSQR loop runs in extended precision (``np.longdouble``, 64-bit
  significand on x86-64; products and row sums in that type, dot products
  summed in order), with sigma_max from the same power iteration in fp64
  (scipy).  The Golub-Kahan recurrence has no reorthogonalization, so a
  rounding difference grows from step to step; this route tells which fp64
  estimate the rounding moved.  Its line also gives the step at which
  sigma_min was set.

``--df64-sell`` adds the JAX package's double-float SELL route
(``_SELL_ROUTE_FORCE``; Pallas in interpret mode, slow).  Prints one JSON
line per route: (cond, sigma_max, sigma_min, t) and seconds.

    python scripts/port_condest_cpu.py --n 262144 --routes jax,extended
    python scripts/port_condest_cpu.py --n 65536
    python scripts/port_condest_cpu.py --n 8192 --df64-sell
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def extended_condest(A, max_iters: int, rand_seed: int = 42):
    """condest's protocol (``gmres_tpu_torch/solver/condest.py``) in numpy:
    the power iteration in fp64, the LSQR loop in ``np.longdouble``.
    Returns (cond, sigma_max, sigma_min, t) and the step that set
    sigma_min."""
    import numpy as np
    import scipy.sparse as sp

    from gmres_tpu_torch.io.rng import rand_vect
    from gmres_tpu_torch.solver.condest import klein_lu_bound, transpose_csr

    n = A.n_rows
    L = np.longdouble

    def arrays(M):
        rp, ci, v = M.numpy_arrays()
        nnz = int(rp[-1])
        return rp.astype(np.int64), ci[:nnz].astype(np.int64), v[:nnz]

    rp, ci, v = arrays(A)
    S = sp.csr_matrix((v, ci, rp), shape=(n, n))
    ops = []
    for r, c, vals in (arrays(A), arrays(transpose_csr(A))):
        empty = r[:-1] == r[1:]
        ops.append((np.minimum(r[:-1], len(vals) - 1), c, vals.astype(L), empty))

    def spmv(op, x):
        starts, c, vals, empty = op
        y = np.add.reduceat(vals * x[c], starts)
        y[empty] = 0
        return y

    def nrm2(x):
        return np.sqrt(np.dot(x, x))

    eps = float(np.finfo(np.float64).eps)
    c1, c1_prime = 8 * eps, 4 * eps
    erfinv_c2 = 8.862271574665521045654e-4
    c3, c4 = 1 / (64 * eps), math.sqrt(eps)
    power_iters = klein_lu_bound(0.1, 1e-12, n)
    x_p = rand_vect(n, rand_seed + 5)
    lam = 0.0
    for _ in range(max(power_iters, 2 * min(32, power_iters))):
        y = S @ x_p
        lam = float(np.sqrt(np.dot(y, y)))
        x_p = y / lam if lam != 0 else y
    sigma_max = lam

    A_op, At_op = ops
    x_exact = rand_vect(n, rand_seed).astype(L)
    x_rand_norm = nrm2(x_exact)
    x_exact = x_exact / x_rand_norm
    b = spmv(A_op, x_exact)
    b_norm = nrm2(b)
    beta = b_norm
    u = b / beta
    v = spmv(At_op, u)
    alpha = nrm2(v)
    v = v / alpha
    w, x = v, np.zeros(n, L)
    phi_bar, rho_bar, sigma_min = beta, alpha, L(sigma_max)
    tau = math.sqrt(2) * erfinv_c2 / float(x_rand_norm)

    t, relaxed, t_target, finishing, t_min = 1, False, 0, True, 0
    while True:
        u = spmv(A_op, v) - alpha * u
        beta = nrm2(u)
        u = u / beta if beta != 0 else u
        v = spmv(At_op, u) - beta * v
        alpha = nrm2(v)
        v = v / alpha if alpha != 0 else v
        rho = np.sqrt(rho_bar ** 2 + beta ** 2)
        c, s = rho_bar / rho, beta / rho
        theta, rho_bar = s * alpha, -c * alpha
        phi, phi_bar = c * phi_bar, s * phi_bar
        x = x + (phi / rho) * w
        w = v + (-theta / rho) * w
        d = x_exact - x
        d_norm = nrm2(d)
        ad_norm = nrm2(spmv(A_op, d))
        if ad_norm < sigma_min * d_norm and d_norm != 0:
            sigma_min, t_min = ad_norm / d_norm, t
        t += 1
        if d_norm == 0 or np.isnan(ad_norm):  # degenerate: no tail
            break
        if finishing:
            relaxed = relaxed or float(sigma_min) / sigma_max <= c4
            c1_eff = c1_prime if relaxed else c1
            finished = (float(ad_norm) / (sigma_max * float(nrm2(x)) + float(b_norm)) <= c1_eff
                        or float(d_norm) <= tau or sigma_max / float(sigma_min) >= c3)
            if finished:
                finishing, t_target = False, math.ceil((t - 1) * 1.25)
            elif t > max_iters:
                break
        if not finishing and t > t_target:
            break
    sigma_min = float(sigma_min)
    return (sigma_max / sigma_min, sigma_max, sigma_min, t), {"sigma_min_at_step": t_min}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--max-iters", type=int, default=20000)
    p.add_argument("--routes", default="port,jax,extended")
    p.add_argument("--df64-sell", action="store_true")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gmres_tpu.io import synth as jax_synth
    from gmres_tpu.solver import condest as jax_condest
    from gmres_tpu_torch.io import synth
    from gmres_tpu_torch.solver import condest

    quiet = lambda *a: None  # noqa: E731
    routes = {
        "port": ("port fp64 SELL", lambda: (condest.condest(
            synth.unstructured_mesh(args.n, run=8), max_iters=args.max_iters, verbose=quiet,
            device="cpu"), {})),
        "jax": ("gmres_tpu fp64 CSR", lambda: (jax_condest.condest(
            jax_synth.unstructured_mesh(args.n, run=8), max_iters=args.max_iters,
            verbose=quiet), {})),
        "extended": ("numpy extended-precision LSQR", lambda: extended_condest(
            synth.unstructured_mesh(args.n, run=8), args.max_iters)),
    }
    runs = [routes[r] for r in args.routes.split(",")]
    if args.df64_sell:
        def df64():
            jax_condest._SELL_ROUTE_FORCE = True
            try:
                return jax_condest.condest(jax_synth.unstructured_mesh(args.n, run=8),
                                           max_iters=args.max_iters, verbose=quiet), {}
            finally:
                jax_condest._SELL_ROUTE_FORCE = False
        runs.append(("gmres_tpu df64 SELL", df64))
    for label, fn in runs:
        t0 = time.perf_counter()
        (cond, smax, smin, t), extra = fn()
        print(json.dumps({"route": label, "n": args.n, "cond": cond, "sigma_max": smax,
                          "sigma_min": smin, "t": t, **extra,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
