#!/usr/bin/env python3
"""K3 GRAM (``basis_update_gram``) and K7 (``basis_mgs``) of one checkout of
gmres_tpu_torch on one CUDA device, timed as ``chip_smoke.py`` times them,
with their outputs saved for a bit-for-bit comparison of two checkouts.

    python3 scripts/port_kernels.py [--checkout DIR] [--save FILE]
    python3 scripts/port_kernels.py --compare A.pt B.pt

imports ``gmres_tpu_torch`` from DIR (default: this checkout) and the timer
of this checkout's ``chip_smoke.py`` (L2 flushed, the card kept busy while
the host enqueues the timed call), so two checkouts are timed alike: run
them in turns (A, B, B, A) on the same card, one right after the other.

Shapes are the main path's at convdiff@1M: n = 1,048,576, a 31-row basis of
N(0, 1/n) entries, w of N(0, 1) entries and u of N(0, 1) entries (numpy
seed 0, as ``chip_smoke.check_kernels``), swept over rows 31 and 16, fp32
and fp64; K7 on the near-orthonormal basis of ``chip_smoke.mgs_basis``
(seed 3).  Each time is the median of 20 calls.  Prints the card's name and
power limit (``nvidia-smi --query-gpu=name,power.limit``; it fails without
them), then one JSON line; ``--save`` also writes the outputs (K3 GRAM's w'
and u2, K7's h, w' and norm) to FILE with ``torch.save``.

``--compare`` reads two such files and prints, for each output, whether the
two are bit-equal; it exits 1 if K3 GRAM's w' differs (the redesign keeps
its bits), else 0.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M1 = 31
N = 1024 * 1024
ROWS = (31, 16)


def _timer_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_timer",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(torch, cs, copy_gbs):
    from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok

    rng = np.random.default_rng(0)
    rng.random(N)              # chip_smoke.check_kernels draws x and b first
    rng.standard_normal(N)
    V_np = rng.standard_normal((M1, N)) / np.sqrt(N)
    w_np = rng.standard_normal(N)
    u_np = rng.standard_normal(M1)
    timer = cs.Timer(torch)
    times, outs = {}, {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        s = dt.itemsize
        V = torch.tensor(V_np, dtype=dt, device="cuda")
        w = torch.tensor(w_np, dtype=dt, device="cuda")
        u = torch.tensor(u_np, dtype=dt, device="cuda")
        Vm, wm, _ = cs.mgs_basis(torch, N, dt, 3)
        for rows in ROWS:
            key = f"{name} rows {rows}"
            nbytes = (rows + 2) * N * s
            w1, u2 = ok.update_gram_cuda(V, w, u, rows)
            outs[f"update_gram {key} w1"], outs[f"update_gram {key} u2"] = w1.cpu(), u2.cpu()
            ms = timer(lambda: ok.update_gram_cuda(V, w, u, rows))
            times[f"update_gram {key}"] = dict(ms=ms, of_copy=nbytes / (ms * 1e-3) / 1e9 / copy_gbs)
            h, wm1, nrm = mk.mgs_cuda(Vm, wm, rows)
            outs[f"mgs {key} h"], outs[f"mgs {key} w1"] = h.cpu(), wm1.cpu()
            outs[f"mgs {key} norm"] = nrm.cpu()
            ms = timer(lambda: mk.mgs_cuda(Vm, wm, rows))
            times[f"mgs {key}"] = dict(ms=ms, of_copy=nbytes / (ms * 1e-3) / 1e9 / copy_gbs,
                                       grid=list(mk.mgs_cuda.grid))
        del V, w, u, Vm, wm
    return times, outs


def compare(torch, a_path, b_path) -> int:
    a, b = torch.load(a_path), torch.load(b_path)
    equal = {k: bool(torch.equal(a[k], b[k])) for k in sorted(set(a) & set(b))}
    print(json.dumps({"compare": [a_path, b_path], "bit_equal": equal}), flush=True)
    k3 = [k for k in equal if k.startswith("update_gram") and k.endswith("w1")]
    return 0 if k3 and all(equal[k] for k in k3) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=ROOT)
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args()
    import torch

    if args.compare:
        return compare(torch, *args.compare)
    sys.path.insert(0, os.path.abspath(args.checkout))
    if not torch.cuda.is_available():
        print("port_kernels: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cs = _timer_module()
    copy_ms, copy_gbs = cs.copy_bandwidth(torch)
    times, outs = measure(torch, cs, copy_gbs)
    if args.save:
        torch.save(outs, args.save)
    print(json.dumps(dict(checkout=args.checkout, device=torch.cuda.get_device_name(0),
                          copy_ms=copy_ms, copy_gb_per_s=copy_gbs, kernels=times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
