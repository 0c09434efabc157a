#!/usr/bin/env python3
"""Walls of gmres_tpu_torch solves of convdiff@1M on one CUDA device, to
compare two checkouts of the port on the same card.

    python3 scripts/port_walls.py [--checkout DIR] [--reps N] [--orth cgsr|mgs]
                                  [--precond identity|ilu_jacobi|ilu]

imports ``gmres_tpu_torch`` from DIR (default: this checkout), stages
``convection_diffusion_2d(1024, beta=2.0)``, and after one warm-up solve per
mode times N solves per mode (identity preconditioner, restart 30, tol
1e-8; with ``--precond`` ILU-Jacobi(3) or exact ILU, M built on the host
once per mode and passed as ``M=``), the modes alternating.  Prints on its
first line the card's name and
power limit (``nvidia-smi --query-gpu=name,power.limit``; it fails without
them), then one JSON line: per mode the walls, their median and the
history.  Run it for two checkouts in turns (A, B, B, A) on the same card,
one right after the other.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--orth", default="cgsr")
    ap.add_argument("--precond", default="identity", choices=("identity", "ilu_jacobi", "ilu"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.checkout))
    import torch

    if not torch.cuda.is_available():
        print("port_walls: torch sees no CUDA device", file=sys.stderr)
        return 1
    import gmres_tpu_torch as g
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.precond.build import build_preconditioner, optimize_precond_format

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    A = convection_diffusion_2d(1024, beta=2.0)
    b = torch.tensor(A.to_scipy() @ g.rand_vect(A.n_rows, 42), device="cuda")
    A_dev = g.stage(A)
    cfgs = {mode: g.GmresConfig(precision=g.PrecisionSpec.from_mode(mode), orth=args.orth,
                                precond=args.precond, jacobi_steps=3, restart_length=30,
                                tol=1e-8, max_restarts=80)
            for mode in ("baseline", "mixed")}
    Ms = {mode: None if args.precond == "identity" else
          optimize_precond_format(build_preconditioner(A, cfg)).to("cuda")
          for mode, cfg in cfgs.items()}
    out = {}
    for mode, cfg in cfgs.items():
        res = g.solve(A_dev, b, cfg, M=Ms[mode])
        out[mode] = dict(walls=[], history=[res.restarts, res.total_iters])
    for _ in range(args.reps):
        for mode, cfg in cfgs.items():
            t0 = time.perf_counter()
            g.solve(A_dev, b, cfg, M=Ms[mode])
            torch.cuda.synchronize()
            out[mode]["walls"].append(time.perf_counter() - t0)
    for mode in out:
        out[mode]["median"] = statistics.median(out[mode]["walls"])
    print(json.dumps(dict(checkout=args.checkout, orth=args.orth, precond=args.precond,
                          device=torch.cuda.get_device_name(0), modes=out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
