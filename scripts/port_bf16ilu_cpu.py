#!/usr/bin/env python3
"""The bf16 ILU-Jacobi(3) solves of ``chip_smoke.py``'s convdiff-bf16ilu
path, on the CPU, in the JAX package (``jax``) and the port through its
plain versions (``port``): ``convection_diffusion_2d(nx, beta=2.0)``,
x_true = rand_vect(n, 42), b = A x_true, restart length 30, tol 1e-8, at
most 80 restarts, M = ILU-Jacobi(3) built in bf16:

- ``bf16``: the bf16 inner tier, ``PrecisionSpec("float64", "bfloat16",
  "bfloat16")``, with its stall escalation to fp32 (the JAX package checks
  the stall every cycle, ``host_sync_every=1``, as the port does);
- ``fp32``: fp32 inner with the bf16 M, ``PrecisionSpec("float64",
  "float32", "bfloat16")``;

under CGSR and sequential MGS (``--orth``).  Prints one JSON line per route,
tier and orthogonalization: converged, escalated, restarts before and after
the escalation, iterations and seconds.  These are the counts the card's
solves are held to (``chip_smoke.BF16ILU_CPU``).

``--exact-restarts K`` runs instead the bf16 tier with bf16 exact ILU (its
sweep form at ``convection_diffusion_2d(512)``), CGSR, cut at K restarts,
and prints each route's backward error per cycle (``chip_smoke.
BF16_EXACT_CPU``).

The JAX package reaches bf16's eps through ``np.finfo(ml_dtypes.bfloat16)``,
which numpy 2 refuses; here ``np.finfo`` answers ``ml_dtypes.finfo`` for that
one type (eps 2^-7), the value the JAX code means
(``gmres_tpu/precond/ilu0.py:84``).

    python scripts/port_bf16ilu_cpu.py --nx 256
    python scripts/port_bf16ilu_cpu.py --nx 512 --exact-restarts 2
    python scripts/port_bf16ilu_cpu.py --nx 128 --routes jax,port --orth cgsr
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIERS = {"bf16": ("float64", "bfloat16", "bfloat16"),
         "fp32": ("float64", "float32", "bfloat16")}
SETTINGS = dict(precond="ilu_jacobi", jacobi_steps=3, restart_length=30, tol=1e-8,
                max_restarts=80)


def _bf16_finfo():
    import ml_dtypes
    import numpy as np

    finfo = np.finfo

    def bf16_finfo(dtype):
        if np.dtype(dtype) == np.dtype(ml_dtypes.bfloat16):
            return ml_dtypes.finfo(ml_dtypes.bfloat16)
        return finfo(dtype)

    np.finfo = bf16_finfo


def _phases(res):
    marks = [i for i, h in enumerate(res.history) if h.get("escalated")]
    before = marks[0] if marks else res.restarts
    return before, res.restarts - before


def run_jax(nx, tier, orth, **kw):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    import gmres_tpu
    from gmres_tpu.io.rng import rand_vect
    from gmres_tpu.io.synth import convection_diffusion_2d
    from gmres_tpu.ops.spmv import spmv

    A = convection_diffusion_2d(nx, beta=2.0)
    b = np.asarray(spmv(A, jnp.asarray(rand_vect(A.n_rows, 42))))
    cfg = gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec(*TIERS[tier]), orth=orth,
                                host_sync_every=1, **{**SETTINGS, **kw})
    return gmres_tpu.solve(A, b, cfg, record_history=True)


def run_port(nx, tier, orth, **kw):
    import gmres_tpu_torch as g
    from gmres_tpu_torch.io.synth import convection_diffusion_2d

    A = convection_diffusion_2d(nx, beta=2.0)
    b = A.to_scipy() @ g.rand_vect(A.n_rows, 42)
    cfg = g.GmresConfig(precision=g.PrecisionSpec(*TIERS[tier]), orth=orth,
                        **{**SETTINGS, **kw})
    return g.solve(A, b, cfg, record_history=True, device="cpu")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--routes", default="jax,port")
    ap.add_argument("--tiers", default="bf16,fp32")
    ap.add_argument("--orth", default="cgsr,mgs")
    ap.add_argument("--exact-restarts", type=int, default=0)
    args = ap.parse_args(argv)
    _bf16_finfo()
    runners = {"jax": run_jax, "port": run_port}
    if args.exact_restarts:
        for route in args.routes.split(","):
            t0 = time.perf_counter()
            res = runners[route](args.nx, "bf16", "cgsr", precond="ilu",
                                 max_restarts=args.exact_restarts)
            print(json.dumps(dict(route=route, nx=args.nx, precond="ilu", tier="bf16",
                                  restarts=int(res.restarts),
                                  history=[h["rel_initial"] for h in res.history],
                                  seconds=round(time.perf_counter() - t0, 2))), flush=True)
        return
    for route in args.routes.split(","):
        for tier in args.tiers.split(","):
            for orth in args.orth.split(","):
                t0 = time.perf_counter()
                res = runners[route](args.nx, tier, orth)
                before, after = _phases(res)
                print(json.dumps(dict(route=route, nx=args.nx, tier=tier, orth=orth,
                                      converged=bool(res.converged),
                                      escalated=bool(res.escalated), restarts=int(res.restarts),
                                      bf16_restarts=before, fp32_restarts=after,
                                      total_iters=int(res.total_iters),
                                      seconds=round(time.perf_counter() - t0, 2))), flush=True)


if __name__ == "__main__":
    main()
