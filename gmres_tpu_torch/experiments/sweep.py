"""Experiment sweep runner: the reference's ``automated.py``, in-process
(``gmres_tpu/experiments/sweep.py``).  Results flow as structured rows and
are appended in the reference's CSV schema and as JSONL
(``experiments/history.py``).

    python -m gmres_tpu_torch.experiments.sweep --prec identity --orth cgsr \\
        --no-singleprec --no-single convdiff:1024 30 0 1e-8 42

It runs the Cartesian product over (rlen x rtol x tol x rorth x mode x
prec x seed) like ``automated.py:152-156``, the seeds iterated directly.
``--device`` is ``cuda`` (the default) or ``cpu`` and is recorded in the
rows' device column.  The operator is staged once for the whole sweep
(``gmres_tpu_torch.stage``) and each solve gets a preconditioner built from
the CSR matrix.  ``--warmup`` untimed solves run before the first recorded
row of each configuration (seed excluded), so every recorded row is warm,
as the reference's precompiled binaries are.  ``--dist`` solves each
configuration with ``solve_distributed`` over the process group of
``cli/solve.py``'s ``--dist`` (the CSR matrix on every rank, partitioned by
the solve; no staging); rank 0 alone prints and writes the rows.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np


def run_one(A, mat, mode, orth, prec, rlen, rtol, rorth, tol, max_restarts,
            repeated_iter, seed, device, b_path=None, A_staged=None, warmup=0, dist=False):
    """One configuration, as a row of the history.  ``A`` is the CSR
    matrix; ``A_staged`` (optional) the operator staged once by the caller,
    which the solves use while ``A`` builds the preconditioner; ``dist``
    solves with ``solve_distributed`` (every rank calls this alike).  ``warmup``
    untimed solves are discarded first.  A run the solver reports as
    diverged (aborted, not converged) is recorded as a row of ``-`` fields,
    as the reference records it; an exception (a failed kernel build or
    launch, an unported option) propagates, where the reference records a
    crashed run as dashes."""
    import torch

    from gmres_tpu_torch.cli.solve import host_spmv
    from gmres_tpu_torch.config import GmresConfig
    from gmres_tpu_torch.experiments.history import MODE_CODES
    from gmres_tpu_torch.io.loader import load_vector
    from gmres_tpu_torch.io.rng import rand_vect
    from gmres_tpu_torch.parallel.dist_gmres import solve_distributed
    from gmres_tpu_torch.precond.build import build_preconditioner
    from gmres_tpu_torch.solver.gmres import solve

    n = A.n_rows
    if b_path:
        x_host = np.zeros(n)
        b_host = load_vector(b_path)
    else:
        x_host = rand_vect(n, seed)
        b_host = host_spmv(A, x_host)

    jacobi_steps = 1
    prec_name = prec
    if prec.startswith("ilu_jacobi(") and prec.endswith(")"):
        jacobi_steps = int(prec[len("ilu_jacobi("):-1])
        prec_name = "ilu_jacobi"
    cfg = GmresConfig.from_flags(
        mode=mode, orth=orth, prec=prec_name, rlen=rlen,
        rtol=(rtol if rorth == 0 else rorth), tol=tol, max_restarts=max_restarts,
        repeat_iter=repeated_iter, orthloss=rorth != 0, jacobi_steps=jacobi_steps)

    if dist:
        op, kw, run = A, {}, solve_distributed
    elif A_staged is not None:
        M = build_preconditioner(A, cfg)  # from CSR (ILU needs it)
        op, kw, run = A_staged, dict(M=M), solve
    else:
        op, kw, run = A, {}, solve
    for _ in range(warmup):
        run(op, b_host, cfg, device=device, **kw)
    res = run(op, b_host, cfg, device=device, **kw)

    row = {
        "mat": mat,
        "type": MODE_CODES[mode],
        "orth": orth.upper() if orth != "cgsr" else "CGSR",
        "rlen": str(rlen),
        "rtol": ("R" if repeated_iter else "") + f"{rtol:g}",
        "rorth": f"{rorth:g}",
        "tol": f"{tol:g}",
        "device": device,
        "prec": prec,
        "seed": seed,
    }
    if res.aborted and not res.converged:
        row.update({k: "-" for k in ("i", "total_iters", "res", "err", "ilu", "gmres")})
        return row

    x64 = res.x.detach().to("cpu", torch.float64).numpy()
    row.update(
        i=str(res.restarts),
        total_iters=str(res.total_iters),
        res=f"{np.linalg.norm(b_host - host_spmv(A, x64)):g}",
        err=f"{np.linalg.norm(x64 - x_host):g}",
        ilu=f"{res.prec_seconds:g}",
        gmres=f"{res.solve_seconds:g}",
    )
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Runs experiments for mixed precision gmres (PyTorch and CUDA)")
    p.add_argument("--no-baseline", dest="skip_baseline", action="store_true")
    p.add_argument("--no-mixed", dest="skip_mixed", action="store_true")
    p.add_argument("--no-singleprec", dest="skip_singlePrec", action="store_true")
    p.add_argument("--no-single", dest="skip_single", action="store_true")
    p.add_argument("--orth", default="mgs")
    p.add_argument("--rorth", default="0")
    p.add_argument("--repeated-iter", dest="repeated_iter", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dist", action="store_true")
    p.add_argument("--prec", default="ilu")
    p.add_argument("--max-restarts", default="1000000")
    p.add_argument("--warmup", type=int, default=1,
                   help="untimed solves discarded before the first recorded run of each "
                        "distinct config; 0 records the cold first run")
    p.add_argument("--rhs", action="store_true")
    p.add_argument("--out-dir", default=".")
    p.add_argument("mat")
    p.add_argument("rlens")
    p.add_argument("rtols")
    p.add_argument("tols")
    p.add_argument("seeds", nargs="?", default="42")
    args = p.parse_args(argv)

    from gmres_tpu_torch.cli.solve import dist_output
    from gmres_tpu_torch.solver.gmres import resolve_device

    resolve_device(args.device)
    with dist_output(args.dist):
        return _sweep(args)


def _sweep(args) -> int:
    import torch.distributed as dist

    from gmres_tpu_torch.cli.solve import make_synth
    from gmres_tpu_torch.experiments.history import append_rows
    from gmres_tpu_torch.io.loader import load_matrix
    from gmres_tpu_torch.solver.gmres import stage

    mat = args.mat
    if mat.startswith(("poisson2d:", "poisson3d:", "convdiff:", "mesh:", "mesh3d:")):
        A = make_synth(mat)
        mat_name = mat.replace(":", "")
        b_path = None
    else:
        mat_dir = os.getenv("MTXDIR", "mats")
        A = load_matrix(os.path.join(mat_dir, mat + ".mtx"))
        mat_name = mat
        b_path = os.path.join(mat_dir, mat + "_b.mtx") if args.rhs else None

    def _split(s: str) -> list:
        # list-valued args accept space- or comma-separated values
        return s.replace(",", " ").split()

    rlens = [int(x) for x in _split(args.rlens)]
    rtols = [float(x) for x in _split(args.rtols)] if args.rtols else [0.0]
    tols = [float(x) for x in _split(args.tols)]
    rorths = [float(x) for x in _split(args.rorth)]
    seeds = [int(x) for x in _split(args.seeds)]
    precs = _split(args.prec)
    modes = (([] if args.skip_baseline else ["baseline"])
             + ([] if args.skip_mixed else ["mixed"])
             + ([] if args.skip_singlePrec else ["single-prec"])
             + ([] if args.skip_single else ["single"]))

    # the repack and upload, once (a distributed solve partitions the CSR)
    A_staged = None if args.dist else stage(A, device=args.device)
    rows = []
    warmed = set()  # configurations (seed excluded) already warm
    try:
        for rl, rt, t, ro, mode, prec, seed in itertools.product(
                rlens, rtols, tols, rorths, modes, precs, seeds):
            print(f"test: {mat_name} {mode} {args.orth} tol = {t:g} rlen = {rl} "
                  f"rtol = {rt:g} rorth = {ro:g} seed = {seed} prec = {prec}", flush=True)
            cfg_key = (rl, rt, t, ro, mode, prec)
            warmup = 0 if cfg_key in warmed else args.warmup
            warmed.add(cfg_key)
            row = run_one(A, mat_name, mode, args.orth.lower(), prec, rl, rt, ro, t,
                          int(args.max_restarts), args.repeated_iter, seed, args.device,
                          b_path, A_staged=A_staged, warmup=warmup, dist=args.dist)
            print(f"  -> i={row['i']} iters={row['total_iters']} res={row['res']} "
                  f"err={row['err']} ilu={row['ilu']}s gmres={row['gmres']}s", flush=True)
            rows.append(row)
    finally:  # the rows run so far are kept when a run raises
        if not args.dist or dist.get_rank() == 0:
            append_rows(mat_name, rows, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
