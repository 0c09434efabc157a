"""The solve command line, with the flags and the output of the reference's
``gmres_perf_test`` (``gmres_perf_test.cpp:309-455``; ``gmres_tpu/cli/solve.py``).

    python -m gmres_tpu_torch.cli.solve --synth convdiff:1024 --mode mixed \\
        --orth cgsr --prec identity --rlen 30 --tol 1e-8 --json

The summary block is a contract: the reference's sweep runner scrapes it
with a regex (``automated.py:33-38``; ``tests/test_cli.py:SUMMARY_REGEX``).
Numbers print with C++ ``cout``'s default ``%g`` formatting.  ``--json``
adds a line with the structured result.

``--device`` is ``cuda`` (the default; ``--gpu`` is the reference's
spelling of it) or ``cpu``; without a CUDA device the default raises, as
``solve`` does.  ``--dist`` solves row-partitioned (``solve_distributed``)
over the default process group when a launcher or ``parallel/launch.py:
spawn`` has initialized one, every rank running this command with the same
flags; otherwise over a one-rank gloo group of its own
(``launch.command_group``), as the JAX package's ``--dist`` runs over all
the devices of one chip.  Rank 0 alone prints, the same block as the
single-device command.

Without ``--bpath``, b = A x_true for x_true = ``rand_vect(n, --rand)``,
with the product summed row by row in the order of the stored entries, as
the JAX package's CSR product sums them (``host_spmv``), so b has the same
bits in both packages and on either device.  ``main(argv)`` returns the exit
code.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np


def fmt(x: float) -> str:
    """C++ ostream default float formatting (6 significant digits)."""
    return f"{float(x):g}"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gmres-solve",
        description="mixed-precision GMRES on PyTorch and CUDA (reference-parity CLI)")
    p.add_argument("--Apath", default=None)
    p.add_argument("--bpath", default=None)
    p.add_argument("--rlen", type=int, default=0)
    p.add_argument("--rtol", type=float, default=0.0)
    p.add_argument("--repeat-iter", action="store_true", dest="repeat_iter")
    p.add_argument("--orthloss", action="store_true")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--max-restarts", type=int, default=1_000_000, dest="max_restarts")
    p.add_argument("--rand", type=int, default=42)
    p.add_argument("--mode", choices=["mixed", "baseline", "single-prec", "single", "df64"],
                   default="mixed")
    p.add_argument("--orth", type=str.lower, choices=["cgs", "mgs", "cgsr"], default="mgs")
    p.add_argument("--prec", choices=["ilu", "ilu_jacobi", "jacobi", "identity"], default="ilu")
    p.add_argument("--jacobi-steps", type=int, default=1, dest="jacobi_steps")
    p.add_argument("--gpu", action="store_true",
                   help="the reference's flag for the GPU: --device cuda")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dist", action="store_true",
                   help="row-partition over the ranks of the process group")
    p.add_argument("--inner-dtype", choices=["float32", "bfloat16"], default=None,
                   help="override the mode's inner dtype")
    p.add_argument("--basis-dtype", choices=["float32", "bfloat16"], default=None,
                   help="compressed Krylov-basis storage (CB-GMRES, arXiv:2009.12101)")
    p.add_argument("--json", action="store_true", help="emit a JSON result line too")
    p.add_argument("--synth", default=None,
                   help="synthetic matrix instead of --Apath, e.g. poisson2d:512, "
                        "poisson3d:64, convdiff:512, mesh:4096, mesh3d:4096")
    return p


def make_synth(spec: str):
    from gmres_tpu_torch.io import synth

    kind, _, size = spec.partition(":")
    n = int(size) if size else 64
    if kind == "poisson2d":
        return synth.poisson_2d(n)
    if kind == "poisson3d":
        return synth.poisson_3d(n)
    if kind == "convdiff":
        return synth.convection_diffusion_2d(n)
    if kind == "mesh":
        return synth.unstructured_mesh(n)
    if kind == "mesh3d":  # 3D-FEM/cage-class row density
        return synth.unstructured_mesh(n, run=8)
    raise SystemExit(f"unknown synthetic matrix {spec!r}")


@contextlib.contextmanager
def dist_output(dist_run: bool):
    """The body's context for ``--dist``: the process group
    (``launch.command_group``), and standard output kept only on rank 0."""
    if not dist_run:
        yield
        return
    import torch.distributed as dist

    from gmres_tpu_torch.parallel import launch

    with launch.command_group():
        if dist.get_rank() == 0:
            yield
        else:
            with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
                yield


def host_spmv(A, x: np.ndarray) -> np.ndarray:
    """y = A x for a CSR matrix in fp64 on the host, each row summed from 0
    in the order of its stored entries: the JAX package's CSR product
    (a sorted ``segment_sum``), bit for bit."""
    row_ptr, col_idx, vals = A.numpy_arrays()
    nnz = int(row_ptr[-1])
    rows = np.repeat(np.arange(A.n_rows), np.diff(row_ptr))
    y = np.zeros(A.n_rows)
    np.add.at(y, rows, vals[:nnz].astype(np.float64) * np.asarray(x, np.float64)[col_idx[:nnz]])
    return y


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from gmres_tpu_torch.solver.gmres import resolve_device

    if args.repeat_iter and args.orthloss:
        print("Repeated Iteration Restart cannot be used with OrthLoss restart")
        return 1
    if args.Apath is None and args.synth is None:
        # the reference's message, word for word (gmres_perf_test.cpp:402)
        print("No value suplied for A")
        return 1
    dev = resolve_device("cuda" if args.gpu else args.device)
    with dist_output(args.dist):
        return _run(args, dev)


def _run(args, dev) -> int:
    import torch

    from gmres_tpu_torch.config import GmresConfig, PrecisionSpec
    from gmres_tpu_torch.io.loader import load_matrix, load_vector
    from gmres_tpu_torch.io.rng import rand_vect
    from gmres_tpu_torch.parallel.dist_gmres import solve_distributed
    from gmres_tpu_torch.solver.gmres import solve

    A = make_synth(args.synth) if args.synth else load_matrix(args.Apath)
    n = A.n_rows
    if args.bpath is None:
        x_host = rand_vect(n, args.rand)
        b_host = host_spmv(A, x_host)
    else:
        x_host = np.zeros(n)
        b_host = load_vector(args.bpath)

    precision = PrecisionSpec.from_mode(args.mode)
    if args.inner_dtype:
        precision = dataclasses.replace(precision, inner=args.inner_dtype,
                                        precond=args.inner_dtype)
    if args.basis_dtype:
        precision = dataclasses.replace(precision, basis=args.basis_dtype)
    cfg = GmresConfig.from_flags(
        mode=args.mode, orth=args.orth, prec=args.prec,
        rlen=args.rlen if args.rlen > 0 else 30, rtol=args.rtol, tol=args.tol,
        max_restarts=args.max_restarts, repeat_iter=args.repeat_iter,
        orthloss=args.orthloss, jacobi_steps=args.jacobi_steps,
    ).with_(precision=precision)

    print(f"||x|| = {fmt(np.linalg.norm(x_host))}")
    print(f"||b|| = {fmt(np.linalg.norm(b_host))}")
    print(f"||A|| = {fmt(np.linalg.norm(A.vals.numpy()))}")
    print("Doing Mixed Precision test" if args.mode == "mixed" else "Doing Baseline test")

    res = (solve_distributed if args.dist else solve)(A, b_host, cfg, device=dev)
    if res.aborted:
        print(f"Aborting after {res.total_iters} iterations")
    else:
        print(f"Found solution with rel prec res norm = {fmt(res.rel_prec_res)} "
              f"when k = {res.final_k} and i = {res.restarts}")
        print(f"  total iterations = {res.total_iters}")

    # the true fp64 residual and error (gmres_perf_test.cpp:104-115)
    x64 = res.x.detach().to("cpu", torch.float64).numpy()
    res_norm = np.linalg.norm(b_host - host_spmv(A, x64))
    err_norm = np.linalg.norm(x64 - x_host)
    print(f"  ilu took {fmt(res.prec_seconds)}s; gmres took {fmt(res.solve_seconds)}s")
    print(f"  resNorm = {fmt(res_norm)}; errNorm = {fmt(err_norm)}")
    if args.json:
        print(json.dumps({
            "converged": res.converged, "aborted": res.aborted, "k": res.final_k,
            "i": res.restarts, "total_iters": res.total_iters,
            "rel_prec_res": res.rel_prec_res, "res_norm": float(res_norm),
            "err_norm": float(err_norm), "prec_seconds": res.prec_seconds,
            "solve_seconds": res.solve_seconds, "n": n, "nnz": A.nnz,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
