#!/usr/bin/env python3
"""K2 (``basis_gram``) of one checkout of gmres_tpu_torch on one CUDA device:
its time beside ``torch.mv``'s and a device copy's, its error against an
extended-precision sum, and the ILU-Jacobi(3) history at convdiff@1M that
K2's fp64 rounding moves.

    python3 scripts/port_k2.py [--checkout DIR] [--history] [--gram kernel|plain]

imports ``gmres_tpu_torch`` from DIR (default: this checkout) and the timer
of this checkout's ``chip_smoke.py`` (L2 flushed, the card kept busy while
the host enqueues the timed call), so two checkouts are timed alike: run
them in turns (A, B, B, A) on the same card, one right after the other.

K2 runs at convdiff@1M's shapes: a 31-row basis of N(0, 1/n) entries, n =
1,048,576, and w of N(0, 1) entries (numpy seed 0), in fp32 and fp64, each
timed over 20 calls (median), and where the checkout's wrapper takes
``blocks_per_sm``, on 1-4 blocks per SM.  Its error is max_j |u_j - s_j|,
where s is the same sum in numpy's longdouble (64-bit significand on x86),
given in units of the dtype's rounding unit times max_j |s_j| (roundings
of the result) and times max_j sum_i |V_ji w_i| (the summation bound's
scale).

With ``--history`` it then stages ``convection_diffusion_2d(1024,
beta=2.0)``, builds ILU-Jacobi(3) on the host per mode and solves
(baseline, mixed; CGSR, restart 30, tol 1e-8, b = A rand_vect(n, 42)); with
``--gram plain`` K2's wrapper is replaced by its plain version (``torch.mv``
on the card) for those solves.  Prints the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``; it fails without them), then
one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 31
N = 1024 * 1024


def _timer_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_timer",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_records(torch, ok, cs, copy_gbs):
    rng = np.random.default_rng(0)
    V64 = rng.standard_normal((ROWS, N)) / np.sqrt(N)
    w64 = rng.standard_normal(N)
    timer = cs.Timer(torch)
    grid_kw = "blocks_per_sm" in inspect.signature(ok.gram_cuda).parameters
    out = {}
    for name, dt, npdt in (("float32", torch.float32, np.float32),
                           ("float64", torch.float64, np.float64)):
        Vn, wn = V64.astype(npdt), w64.astype(npdt)
        wl = wn.astype(np.longdouble)
        exact = np.array([np.sum(Vn[j].astype(np.longdouble) * wl) for j in range(ROWS)])
        bound = np.array([np.sum(np.abs(Vn[j].astype(np.longdouble) * wl)) for j in range(ROWS)])
        V = torch.tensor(Vn, device="cuda")
        w = torch.tensor(wn, device="cuda")
        got = ok.gram_cuda(V, w, ROWS)
        mv = torch.mv(V, w)
        unit = float(np.finfo(npdt).eps) / 2

        def errs(u):
            e = float(np.max(np.abs(u.cpu().numpy().astype(np.longdouble) - exact)))
            return dict(max_abs_err=e, roundings_of_u=e / (unit * float(np.max(np.abs(exact)))),
                        of_bound_scale=e / (unit * float(np.max(bound))))

        nbytes = (ROWS + 1) * N * dt.itemsize
        rec = dict(ms=timer(lambda: ok.gram_cuda(V, w, ROWS)),
                   mv_ms=timer(lambda: torch.mv(V, w)), kernel=errs(got), mv=errs(mv),
                   repeats=bool(torch.equal(ok.gram_cuda(V, w, ROWS), got)))
        rec["of_copy"] = nbytes / (rec["ms"] * 1e-3) / 1e9 / copy_gbs
        rec["mv_of_copy"] = nbytes / (rec["mv_ms"] * 1e-3) / 1e9 / copy_gbs
        if grid_kw:
            rec["blocks_per_sm"] = {}
            for per_sm in (1, 2, 3, 4):
                same = torch.equal(ok.gram_cuda(V, w, ROWS, blocks_per_sm=per_sm), got)
                ms = timer(lambda: ok.gram_cuda(V, w, ROWS, blocks_per_sm=per_sm))
                rec["blocks_per_sm"][per_sm] = dict(ms=ms, same_bits=bool(same))
        out[name] = rec
        del V, w
    return out


def histories(torch, g, ok, gram):
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.precond.build import build_preconditioner, optimize_precond_format

    if gram == "plain":
        ok.gram_cuda = lambda V, w, rows, *a, **k: ok.gram_plain(V, w, rows)
    A = convection_diffusion_2d(1024, beta=2.0)
    b = torch.tensor(A.to_scipy() @ g.rand_vect(A.n_rows, 42), device="cuda")
    A_dev = g.stage(A)
    out = {}
    for mode in ("baseline", "mixed"):
        cfg = g.GmresConfig(precision=g.PrecisionSpec.from_mode(mode), orth="cgsr",
                            precond="ilu_jacobi", jacobi_steps=3, restart_length=30, tol=1e-8,
                            max_restarts=80)
        M = optimize_precond_format(build_preconditioner(A, cfg)).to("cuda")
        res = g.solve(A_dev, b, cfg, M=M)
        out[mode] = [res.restarts, res.total_iters]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=ROOT)
    ap.add_argument("--history", action="store_true")
    ap.add_argument("--gram", default="kernel", choices=("kernel", "plain"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.checkout))
    import torch

    if not torch.cuda.is_available():
        print("port_k2: torch sees no CUDA device", file=sys.stderr)
        return 1
    import gmres_tpu_torch as g
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cs = _timer_module()
    copy_ms, copy_gbs = cs.copy_bandwidth(torch)
    out = dict(checkout=args.checkout, gram=args.gram, device=torch.cuda.get_device_name(0),
               copy_ms=copy_ms, copy_gb_per_s=copy_gbs)
    if args.gram == "kernel":
        out["k2"] = k2_records(torch, ok, cs, copy_gbs)
    if args.history:
        out["ilu_jacobi"] = histories(torch, g, ok, args.gram)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
