#!/usr/bin/env python3
"""How far the restart count of the distributed block-Jacobi ILU solve at
convdiff(512) is set by rounding: ``chip_smoke.py``'s ``bilu_jacobi(3)
mixed 262K`` case (``convection_diffusion_2d(nx, beta=2.0)``, b = A x_true,
CGSR, ``precond="bilu_jacobi"`` with 3 sweeps, restart length 30, tol 1e-8,
at most 200 restarts, ``--ranks`` gloo ranks), for x_true = rand_vect(n,
seed) at each of ``--seeds``, on each of ``--routes``:

- ``kernels``: the port as it runs (on the card, its hand-written kernels);
- ``plain``: the same solve with every kernel wrapper swapped, in each rank,
  for its plain PyTorch version (on the card, torch ops on CUDA tensors);
  the solve must then launch no kernel.

Each route and seed is read ``--reads`` times, in one spawn of the ranks.
Prints one JSON line per solve: route, seed, read, converged, restarts,
iterations, the backward error (fp64, recomputed here), seconds, the kernel
launches summed over the ranks (non-zero only), and each cycle's backward
error.  Imports nothing of JAX; ``scripts/port_bilu_cpu.py --seeds`` gives
the JAX package's and the port's CPU counts for the same seeds.

    python scripts/dist_bilu_seeds.py                          # on the card
    python scripts/dist_bilu_seeds.py --device cpu --nx 64 --routes kernels
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS = dict(orth="cgsr", precond="bilu_jacobi", jacobi_steps=3, restart_length=30,
                tol=1e-8, max_restarts=200)


def plain_wrappers(on: bool, saved: dict) -> None:
    """Swap (``on``) every ``*_cuda`` kernel wrapper that a module of the
    port holds for its ``*_plain`` version, or put the wrappers back."""
    if not on:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
        saved.clear()
        return
    from gmres_tpu_torch.ops.cuda import kernel_wrappers

    wrappers = {id(fn) for fn in kernel_wrappers().values()}
    for mod in [m for k, m in sys.modules.items() if k.startswith("gmres_tpu_torch")]:
        for name, fn in list(vars(mod).items()):
            if id(fn) in wrappers and name.endswith("_cuda"):
                plain = getattr(sys.modules[fn.__module__], name[:-5] + "_plain")
                saved[(mod, name)] = fn
                setattr(mod, name, plain)


def rank_solves(nx, mode, seeds, routes, reads, device):
    """On each rank: every (route, seed, read) solve in turn; returns their
    outcomes with the global x."""
    import numpy as np
    import torch

    import gmres_tpu_torch as g
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda import kernel_wrappers
    from gmres_tpu_torch.parallel.dist_gmres import solve_distributed

    # the kernels' own wrappers, whose counts the plain route leaves alone
    wrappers = kernel_wrappers()
    A = convection_diffusion_2d(nx, beta=2.0)
    cfg = g.GmresConfig(precision=g.PrecisionSpec.from_mode(mode), **SETTINGS)
    out = []
    for seed in seeds:
        b = A.to_scipy() @ g.rand_vect(A.n_rows, seed)
        for route in routes:
            saved = {}
            plain_wrappers(route == "plain", saved)
            try:
                for read in range(reads):
                    before = {k: fn.launches for k, fn in wrappers.items()}
                    t0 = time.perf_counter()
                    res = solve_distributed(A, b, cfg, device=device, record_history=True)
                    if res.x.is_cuda:
                        torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                    after = {k: fn.launches for k, fn in wrappers.items()}
                    out.append(dict(route=route, seed=seed, read=read,
                                    converged=bool(res.converged), restarts=int(res.restarts),
                                    total_iters=int(res.total_iters), seconds=seconds,
                                    launches={k: after[k] - before[k] for k in after},
                                    cycles=[float(h["rel_initial"]) for h in res.history],
                                    x=np.asarray(res.x.cpu().numpy())))
            finally:
                plain_wrappers(False, saved)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--nx", type=int, default=512)
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--mode", default="mixed")
    p.add_argument("--seeds", default="42,7,1234")
    p.add_argument("--routes", default="kernels,plain")
    p.add_argument("--reads", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--timeout", type=float, default=1800.0)
    args = p.parse_args()
    import numpy as np

    import gmres_tpu_torch as g
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.parallel import launch

    if args.device == "cuda":
        from gmres_tpu_torch.ops.cuda._build import library

        library()  # built here, so that the ranks load it
    seeds = [int(s) for s in args.seeds.split(",")]
    routes = args.routes.split(",")
    ranks = launch.spawn(rank_solves, args.ranks,
                         args=(args.nx, args.mode, seeds, routes, args.reads, args.device),
                         timeout=args.timeout, threads=args.threads)
    A = convection_diffusion_2d(args.nx, beta=2.0)
    S = A.to_scipy()
    a_fro = float(np.linalg.norm(A.vals.numpy()))
    failed = []
    for j, got in enumerate(ranks[0]):
        b = S @ g.rand_vect(A.n_rows, got["seed"])
        x = got.pop("x")
        backward = float(np.linalg.norm(b - S @ x)
                         / (np.linalg.norm(b) + a_fro * np.linalg.norm(x)))
        launches = {k: sum(r[j]["launches"][k] for r in ranks) for k in got["launches"]}
        got["launches"] = {k: v for k, v in launches.items() if v}
        got.update(nx=args.nx, ranks=args.ranks, mode=args.mode, device=args.device,
                   backward_error=backward)
        print(json.dumps(got), flush=True)
        if not got["converged"] or backward > 1e-8:
            failed.append(f"{got['route']} seed {got['seed']} read {got['read']}: not converged")
        if got["route"] == "plain" and got["launches"]:
            failed.append(f"plain seed {got['seed']}: kernels launched {got['launches']}")
        if (got["route"] == "kernels" and args.device == "cuda"
                and not got["launches"].get("dia_spmv")):
            failed.append(f"kernels seed {got['seed']}: K1 never launched")
    if failed:
        print("FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
