#!/usr/bin/env python3
"""The block-Jacobi ILU solves of ``chip_smoke.py``'s convdiff-dist path, on
the CPU, in the JAX package (``jax``: ``solve_distributed`` on a
``--ranks``-device CPU mesh) and the port (``port``: ``solve_distributed``
on as many gloo ranks, through the kernels' plain versions):
``convection_diffusion_2d(nx, beta=2.0)``, x_true = rand_vect(n, seed) for
each of ``--seeds`` (42 alone by default), b = A x_true, CGSR, ``precond="bilu_jacobi"`` with 3 sweeps, restart length 30,
tol 1e-8, at most 200 restarts, in each ``--modes`` mode.  Prints one JSON
line per route, mode and seed: converged, restarts, iterations, the backward
error and seconds (with ``--history``, each cycle's backward error too).
The JAX package's counts and first cycles are what the card's solve at this
size is held to (``chip_smoke.BILU_CPU``, ``BILU_CPU_CYCLES``).

    python scripts/port_bilu_cpu.py --nx 512 --history
    python scripts/port_bilu_cpu.py --nx 128 --routes jax,port
    python scripts/port_bilu_cpu.py --modes mixed --routes jax,port --seeds 42,7,1234
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS = dict(orth="cgsr", precond="bilu_jacobi", jacobi_steps=3, restart_length=30,
                tol=1e-8, max_restarts=200)


def _backward(A, x, b):
    import numpy as np

    r = b - A.to_scipy() @ x
    return float(np.linalg.norm(r) / (np.linalg.norm(b) + np.linalg.norm(np.asarray(A.vals)[:A.nnz])
                                      * np.linalg.norm(x)))


def run_jax(nx, mode, ranks, seed, history=False):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={ranks}")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import gmres_tpu
    from gmres_tpu.io.rng import rand_vect
    from gmres_tpu.io.synth import convection_diffusion_2d
    from gmres_tpu.ops.spmv import spmv
    from gmres_tpu.parallel.dist_gmres import AXIS, solve_distributed

    A = convection_diffusion_2d(nx, beta=2.0)
    b = np.asarray(spmv(A, jnp.asarray(rand_vect(A.n_rows, seed))))
    cfg = gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec.from_mode(mode), **SETTINGS)
    t0 = time.perf_counter()
    res = solve_distributed(A, b, cfg, mesh=Mesh(np.array(jax.devices()[:ranks]), (AXIS,)),
                            record_history=history)
    x = np.asarray(res.x)
    return res, _backward(A, x, b), time.perf_counter() - t0


def run_port(nx, mode, ranks, seed, history=False):
    import gmres_tpu_torch as g
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.parallel import launch
    from gmres_tpu_torch.parallel.dist_gmres import run_cases

    A = convection_diffusion_2d(nx, beta=2.0)
    b = A.to_scipy() @ g.rand_vect(A.n_rows, seed)
    cfg = g.GmresConfig(precision=g.PrecisionSpec.from_mode(mode), **SETTINGS)
    t0 = time.perf_counter()
    case = dict(A=A, b=b, cfg=cfg, history=history)
    res = launch.spawn(run_cases, ranks, args=([case], "cpu"), timeout=3600)[0][0]

    class R:
        converged, restarts, total_iters = res["converged"], res["restarts"], res["total_iters"]
        history = res["history"]

    return R, _backward(A, res["x"], b), time.perf_counter() - t0


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--modes", default="mixed,baseline")
    p.add_argument("--routes", default="jax")
    p.add_argument("--seeds", default="42")
    p.add_argument("--history", action="store_true")
    args = p.parse_args()
    for route in args.routes.split(","):
        for mode, seed in [(m, int(s)) for m in args.modes.split(",")
                           for s in args.seeds.split(",")]:
            res, backward, seconds = {"jax": run_jax, "port": run_port}[route](
                args.nx, mode, args.ranks, seed, args.history)
            out = dict(route=route, nx=args.nx, ranks=args.ranks, mode=mode, seed=seed,
                       converged=bool(res.converged), restarts=int(res.restarts),
                       total_iters=int(res.total_iters), backward_error=backward,
                       seconds=round(seconds, 2))
            if args.history:
                out["cycles"] = [float(h["rel_initial"]) for h in res.history]
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
