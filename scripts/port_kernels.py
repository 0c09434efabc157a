#!/usr/bin/env python3
"""K1 (``dia_spmv``, ``dia_residual`` and their lane forms), K3 GRAM
(``basis_update_gram``), K7 (``basis_mgs``), K12 (``dia_spmv_halo`` and
``dia_residual_halo``), K10 (``df_update_gram``) and K11
(``df_update_sumsq``) of one checkout of gmres_tpu_torch on one CUDA
device, timed as ``chip_smoke.py`` times them, with their outputs saved for
a bit-for-bit comparison of two checkouts; beside them the outputs (and
times) of K2, K3 SUMSQ and K3 plain in fp32 and fp64, whose bits every
change of the sweeps' dtype forms keeps, and of K2x2 in its four forms and
K4 in its eight.

    python3 scripts/port_kernels.py [--checkout DIR] [--save FILE]
    python3 scripts/port_kernels.py --compare A.pt B.pt
    python3 scripts/port_kernels.py --pairs P --parent DIR

imports ``gmres_tpu_torch`` from DIR (default: this checkout) and the timer
and inputs of this checkout's ``chip_smoke.py`` (L2 flushed, the card kept
busy while the host enqueues the timed call), so two checkouts are timed
alike: run them in turns (A, B, B, A) on the same card, one right after the
other.

Shapes are the main path's:
- K1 at convdiff@1M (``convection_diffusion_2d(1024, beta=2.0)``, n =
  1,048,576, offsets +-1 and +-1024): plain mode on x of U(0, 1) entries in
  fp32 and fp64; residual mode on the fp64 operator, x and b of U(0, 1) and
  N(0, 1) entries, its norm in fp32 and fp64 (numpy seed 0, as
  ``chip_smoke.check_kernels``); the lane form at s = 1, 2, 4, 8 in both
  modes and dtypes, plain mode on the strided view V[:, 1] of an (8, 3, n)
  lane basis, residual mode on (8, n) B and X (seed 14, as
  ``chip_smoke.check_lane_kernels``).  Each beside its bound (its bytes,
  section 2 of PERF.md, over this run's copy rate) and, where the
  checkout's wrappers take ``grid``, its time on persistent grids.
- K3 GRAM and K7 at convdiff@1M: n = 1,048,576, a 31-row basis of N(0, 1/n)
  entries, w and u of N(0, 1) entries (numpy seed 0, as
  ``chip_smoke.check_kernels``), rows 31 and 16, fp32 and fp64; K7 on the
  near-orthonormal basis of ``chip_smoke.mgs_basis`` (seed 3).  K2, K3
  SUMSQ and K3 plain on the same inputs as K3 GRAM, and K2x2 (against w and
  row rows - 1) in each form on them cast to its dtypes; K4 in each form
  with the first 30 values of u into an x of U(0, 1) entries (seed 1).
- K12 at the row blocks of convdiff@1M over 4 ranks (r = 262,144, offsets
  +-1 and +-1024, edges of 1024 values; the interior block and the first
  and last, whose open edge is zeros), inputs as
  ``chip_smoke.check_halo_kernels`` draws them; both modes, fp32 and fp64
  (residual mode: the fp64 operator, its norm demoted to fp32 or not).
  Beside it, in the same run: a torch device copy of K12's bytes ((D + 2)
  r values and the edges, half read and half written) in each dtype, and
  K1 (``dia_spmv``) on ``convection_diffusion_2d(512)`` (n = 262,144,
  offsets +-1 and +-512).
- K10 and K11 on the 31-row pair basis of ``chip_smoke.df64_pair_basis``
  (seed 7), rows 31 and 16.
Each time is the median of 20 calls; K3 GRAM, K10 and K11 also report the
device kernels a call launches (``chip_smoke.device_kernels``).  Prints the
card's name and power limit (``nvidia-smi --query-gpu=name,power.limit``;
it fails without them), then one JSON line; ``--save`` also writes the
outputs to FILE with ``torch.save``.

``--compare`` reads two such files and prints, for each output, whether the
two are bit-equal, and the largest difference of each output that is not;
it exits 1 if K1's y or r in any mode, dtype or lane count, K3 GRAM's w',
K12's y, residual r or sums, K10's w' or K11's w' and sum of squares, or
K4's x in any of its eight forms differ (each redesign keeps those bits),
or any output of K2, K3 (every mode) or K7 in fp32 or fp64 (the dtype
forms keep those), else 0.  K1's sums may differ: since K1's redesign the
launch adds its blocks' partials in block order, where torch.sum added
them before.  K2x2's u0 and u1 may
differ: since K2x2 became K2's kernel with two vectors they are K2's bits,
no longer those of its block partials added by torch.sum.

``--pairs P --parent DIR`` loads the K1, K12, K2x2 and K4 wrappers of the
checkout in DIR and of this one into one process and times them in turns,
P pairs (DIR's, then this one's) for each mode, dtype and lane count of K1
on ``measure_k1``'s inputs, each mode and dtype of K12 on the interior
block of ``measure_halo``, each form of K2x2 (31 rows) and of K4 (30
coefficients) on ``measure_forms_kept``'s inputs; it prints each form's
pairs and how many of them this checkout's kernel won, in one JSON line.
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
M1 = 31
N = 1024 * 1024
ROWS = (31, 16)
RANKS = 4
LANES = (1, 2, 4, 8)
# outputs whose bits each redesign keeps (suffixes of the saved keys)
KEPT = (("k1_spmv", "y"), ("k1_residual", "r"), ("k1_lanes", "y"), ("k1_residual_lanes", "r"),
        ("halo_residual", "sums"),
        ("update_gram", "w1"), ("halo_spmv", "y"), ("halo_residual", "r"),
        ("df_update_gram", "w1"), ("df_update_sumsq", "w1"), ("df_update_sumsq", "sumsq"),
        # every output of the fp32 and fp64 sweep forms, which the forms for
        # other dtypes leave as they were
        ("gram", "u"), ("update_gram", "u2"), ("update_sumsq", "w1"), ("update_sumsq", "ss"),
        ("update", "w1"), ("mgs", "h"), ("mgs", "w1"), ("mgs", "norm"),
        # K4's x in each of its eight forms (the redesign keeps them)
        ("axpy", "x"))


def _timer_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_timer",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _of_copy(nbytes, ms, copy_gbs):
    return nbytes / (ms * 1e-3) / 1e9 / copy_gbs


def _kernels_a_call(torch, cs, fn):
    return len(cs.device_kernels(torch, fn))


def k1_inputs(torch):
    """K1's inputs at convdiff@1M: (bands fp64 on the card, offsets, x, b,
    the (8, 3, n) lane basis, B, X), as chip_smoke.check_kernels and
    check_lane_kernels draw them."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.dia import from_csr

    dia = from_csr(convection_diffusion_2d(1024, beta=2.0))
    n = dia.n_rows
    rng = np.random.default_rng(0)
    x, b = rng.random(n), rng.standard_normal(n)
    rng = np.random.default_rng(14)
    V = rng.standard_normal((max(LANES), 3, n))
    B, X = rng.standard_normal((max(LANES), n)), rng.random((max(LANES), n))
    return dia.data.to("cuda", torch.float64), dia.offsets, x, b, V, B, X


def k1_calls(torch, sk, inputs):
    """name -> (call of K1 through the wrappers of module ``sk``, bytes it
    must move, output names): each mode, dtype and lane count.  A call
    passes its keywords (``grid``) to the wrapper."""
    d64, offs, x_np, b_np, V_np, B_np, X_np = inputs
    D, n = d64.shape
    x64, b64 = (torch.tensor(a, device="cuda") for a in (x_np, b_np))
    B64, X64 = (torch.tensor(a, device="cuda") for a in (B_np, X_np))
    calls = {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        sz = dt.itemsize
        data, x = d64.to(dt), x64.to(dt)
        calls[f"k1_spmv {name}"] = (
            lambda data=data, x=x, **kw: sk.dia_spmv_cuda(data, offs, x, **kw),
            (D + 2) * n * sz, ("y",))
        calls[f"k1_residual {name}"] = (
            lambda dt=dt, **kw: sk.dia_residual_cuda(d64, offs, b64, x64, dt, **kw),
            (D + 3) * n * 8, ("r", "r_ss", "x_ss"))
        V = torch.tensor(V_np, dtype=dt, device="cuda")
        for s in LANES:
            X = V[:s, 1]
            calls[f"k1_lanes {name} s{s}"] = (
                lambda data=data, X=X, **kw: sk.dia_spmv_lanes_cuda(data, offs, X, **kw),
                (D + 2 * s) * n * sz, ("y",))
            calls[f"k1_residual_lanes {name} s{s}"] = (
                lambda dt=dt, s=s, **kw: sk.dia_residual_lanes_cuda(d64, offs, B64[:s],
                                                                    X64[:s], dt, **kw),
                (D + 3 * s) * n * 8, ("r", "r_ss", "x_ss"))
    return calls


def measure_k1(torch, timer, copy_gbs, times, outs):
    """K1 in its four modes at convdiff@1M: outputs, times beside the bound,
    and (where the wrappers take ``grid``) times on persistent grids of
    1, 2, 4 and 8 blocks an SM."""
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk

    grid_kw = "grid" in inspect.signature(sk.dia_spmv_cuda).parameters
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key, (fn, nbytes, names) in k1_calls(torch, sk, k1_inputs(torch)).items():
        got = fn()
        for nm, t in zip(names, got if isinstance(got, tuple) else (got,)):
            outs[f"{key} {nm}"] = t.cpu()
        ms = timer(fn)
        rec = dict(ms=ms, bound_ms=nbytes / (copy_gbs * 1e9) * 1e3,
                   of_bound=nbytes / (copy_gbs * 1e9) * 1e3 / ms)
        if grid_kw:
            rec["ms_by_blocks_per_sm"] = {k: timer(lambda: fn(grid=sms * k))
                                          for k in (1, 2, 4, 8)}
        times[key] = rec


def measure_sweeps(torch, cs, timer, copy_gbs, times, outs):
    from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok

    rng = np.random.default_rng(0)
    rng.random(N)              # chip_smoke.check_kernels draws x and b first
    rng.standard_normal(N)
    V_np = rng.standard_normal((M1, N)) / np.sqrt(N)
    w_np = rng.standard_normal(N)
    u_np = rng.standard_normal(M1)
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
            times[f"update_gram {key}"] = dict(
                ms=ms, of_copy=_of_copy(nbytes, ms, copy_gbs),
                kernels=_kernels_a_call(torch, cs, lambda: ok.update_gram_cuda(V, w, u, rows)))
            h, wm1, nrm = mk.mgs_cuda(Vm, wm, rows)
            outs[f"mgs {key} h"], outs[f"mgs {key} w1"] = h.cpu(), wm1.cpu()
            outs[f"mgs {key} norm"] = nrm.cpu()
            ms = timer(lambda: mk.mgs_cuda(Vm, wm, rows))
            times[f"mgs {key}"] = dict(ms=ms, of_copy=_of_copy(nbytes, ms, copy_gbs),
                                       grid=list(mk.mgs_cuda.grid))
        del V, w, u, Vm, wm


def _longdouble(V, w):
    """max_j |V_j . w| and V w summed in numpy's longdouble, V and w as the
    card holds them (a bf16 basis widened exactly)."""
    Vl = V.double().cpu().numpy().astype(np.longdouble)
    return Vl @ w.double().cpu().numpy().astype(np.longdouble)


def measure_forms_kept(torch, timer, times, outs):
    """K2, K3 SUMSQ and K3 plain in fp32 and fp64, K2x2 in its four forms and
    K4 in its eight on measure_sweeps' inputs: their outputs (and times),
    after the profiled measurements (late in a long process the profiler
    records nothing).  K2x2 also: its largest error against a longdouble
    sum, whether u0 and u1 equal K2's u, and (where the checkout's wrapper
    takes blocks_per_sm) its time on 1-4 blocks an SM; K4 (likewise) on its
    persistent grid of 1, 2 and 4 blocks an SM and on one block a tile."""
    from gmres_tpu_torch.ops.cuda import orth_kernel as ok
    from gmres_tpu_torch.ops.cuda import outer_kernel as ou
    from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS, GRAM2_FORMS

    rng = np.random.default_rng(0)
    rng.random(N)
    rng.standard_normal(N)
    V_np = rng.standard_normal((M1, N)) / np.sqrt(N)
    w_np = rng.standard_normal(N)
    u_np = rng.standard_normal(M1)
    x_np = np.random.default_rng(1).random(N)
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        V, w, u = (torch.tensor(a, dtype=dt, device="cuda") for a in (V_np, w_np, u_np))
        for rows in ROWS:
            key = f"{name} rows {rows}"
            for label, fn, names in (
                    ("gram", lambda: ok.gram_cuda(V, w, rows), ("u",)),
                    ("update_sumsq", lambda: ok.update_sumsq_cuda(V, w, u, rows), ("w1", "ss")),
                    ("update", lambda: ok.update_cuda(V, w, u, rows), ("w1",))):
                got = fn()
                for nm, t in zip(names, got if isinstance(got, tuple) else (got,)):
                    outs[f"{label} {key} {nm}"] = t.cpu()
                times[f"{label} {key}"] = dict(ms=timer(fn))
        del V, w, u
    grid_kw = "blocks_per_sm" in inspect.signature(ok.gram2_cuda).parameters
    for (vt, wt), form in GRAM2_FORMS.items():
        V = torch.tensor(V_np, dtype=vt, device="cuda")
        w = torch.tensor(w_np, dtype=wt, device="cuda")
        exact_w = _longdouble(V, w)
        for rows in ROWS:
            vk = V[rows - 1].to(wt)
            exact = (exact_w[:rows], _longdouble(V[:rows], vk))
            key = f"gram2 {form} rows {rows}"
            got = ok.gram2_cuda(V, w, vk, rows)  # (m+1, 2), or an older checkout's pair
            got = got.unbind(1) if torch.is_tensor(got) else got
            outs[f"{key} u0"], outs[f"{key} u1"] = got[0].cpu(), got[1].cpu()
            err = max(float(np.max(np.abs(g[:rows].double().cpu().numpy() - e)))
                      for g, e in zip(got, exact))
            rec = dict(ms=timer(lambda: ok.gram2_cuda(V, w, vk, rows)), longdouble_err=err,
                       bits_of_k2=bool(torch.equal(got[0], ok.gram_cuda(V, w, rows))
                                       and torch.equal(got[1], ok.gram_cuda(V, vk, rows))))
            if grid_kw:
                rec["ms_by_blocks_per_sm"] = {
                    b: timer(lambda: ok.gram2_cuda(V, w, vk, rows, blocks_per_sm=b))
                    for b in (1, 2, 3, 4)}
            times[key] = rec
        del V, w
    grid_kw = "blocks_per_sm" in inspect.signature(ou.basis_axpy_cuda).parameters
    for (vt, yt, xt), form in AXPY_FORMS.items():
        V = torch.tensor(V_np, dtype=vt, device="cuda")
        y = torch.tensor(u_np[:M1 - 1], dtype=yt, device="cuda")
        x = torch.tensor(x_np, dtype=xt, device="cuda")
        outs[f"axpy {form} x"] = ou.basis_axpy_cuda(x.clone(), V, y).cpu()
        rec = dict(ms=timer(lambda: ou.basis_axpy_cuda(x, V, y)))  # x in place
        if grid_kw:
            rec["ms_by_blocks_per_sm"] = {
                b: timer(lambda: ou.basis_axpy_cuda(x, V, y, blocks_per_sm=b))
                for b in (0, 1, 2, 4)}
        times[f"axpy {form}"] = rec
        del V, y, x


def _wrappers(checkout):
    """The orth_kernel, outer_kernel, spmv_kernel and halo_kernel modules of
    gmres_tpu_torch in ``checkout``.  Every module of the package imported before is dropped
    from sys.modules first, so that two checkouts' wrappers can be held in
    one process: each keeps the modules (and the kernel library) it was
    made from."""
    for name in [m for m in sys.modules if m.split(".")[0] == "gmres_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(checkout))
    try:
        from gmres_tpu_torch.ops.cuda import halo_kernel, orth_kernel, outer_kernel, spmv_kernel
    finally:
        sys.path.pop(0)
    return orth_kernel, outer_kernel, spmv_kernel, halo_kernel


def halo_pair_calls(torch, hk, inputs):
    """name -> call of K12 through the wrappers of module ``hk`` on the
    interior block of convdiff@1M over RANKS ranks, each mode and dtype."""
    d64, offs, x64, l64, r64, b64 = inputs
    calls = {}
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        data, x, left, right = (t.to(dt) for t in (d64, x64, l64, r64))
        calls[f"halo_spmv {name} interior"] = (
            lambda data=data, x=x, left=left, right=right:
            hk.dia_spmv_halo_cuda(data, offs, x, left, right))
        calls[f"halo_residual {name} interior"] = (
            lambda dt=dt: hk.dia_residual_halo_cuda(d64, offs, b64, x64, l64, r64, dt))
    return calls


def halo_inputs(torch):
    """The interior block of convdiff@1M over RANKS ranks (measure_halo's
    draw): fp64 bands, offsets, x, the two edges and b on the card."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.parallel.halo import partition_halo

    H = partition_halo(convection_diffusion_2d(1024, beta=2.0), RANKS)
    rng = np.random.default_rng(10)
    r, hl, hr = H.rows_per_shard, H.halo_left, H.halo_right
    x, left, right, b = rng.random(r), rng.random(hl), rng.random(hr), rng.standard_normal(r)
    return (torch.tensor(H.data[1], device="cuda"), H.offsets,
            *(torch.tensor(a, device="cuda") for a in (x, left, right, b)))


def measure_pairs(torch, timer, parent, pairs):
    """K1 in each mode, dtype and lane count (measure_k1's inputs), K12 in
    each mode and dtype (its interior block), K2x2 (31 rows) and K4 (30
    coefficients) in each form on measure_forms_kept's inputs, the wrappers
    of ``parent`` and of this checkout timed in turns: ``pairs`` (parent,
    this) pairs of medians, and the number of pairs this checkout's won."""
    old, new = _wrappers(parent), _wrappers(ROOT)
    from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS, GRAM2_FORMS

    calls = {}
    k1 = k1_inputs(torch)
    for (key, (a, _, _)), (_, (b, _, _)) in zip(k1_calls(torch, old[2], k1).items(),
                                                k1_calls(torch, new[2], k1).items()):
        calls[key] = [a, b]
    halo = halo_inputs(torch)
    for (key, a), b in zip(halo_pair_calls(torch, old[3], halo).items(),
                           halo_pair_calls(torch, new[3], halo).values()):
        calls[key] = [a, b]

    rng = np.random.default_rng(0)
    rng.random(N)
    rng.standard_normal(N)
    V_np = rng.standard_normal((M1, N)) / np.sqrt(N)
    w_np = rng.standard_normal(N)
    u_np = rng.standard_normal(M1)
    x_np = np.random.default_rng(1).random(N)
    for (vt, wt), form in GRAM2_FORMS.items():
        V = torch.tensor(V_np, dtype=vt, device="cuda")
        w = torch.tensor(w_np, dtype=wt, device="cuda")
        vk = V[M1 - 1].to(wt)
        calls[f"gram2 {form}"] = [lambda ok=ok, V=V, w=w, vk=vk: ok.gram2_cuda(V, w, vk, M1)
                                  for ok, *_ in (old, new)]
    for (vt, yt, xt), form in AXPY_FORMS.items():
        V = torch.tensor(V_np, dtype=vt, device="cuda")
        y = torch.tensor(u_np[:M1 - 1], dtype=yt, device="cuda")
        x = torch.tensor(x_np, dtype=xt, device="cuda")
        calls[f"axpy {form}"] = [lambda ou=ou, V=V, y=y, x=x: ou.basis_axpy_cuda(x, V, y)
                                 for _, ou, *_ in (old, new)]  # x in place
    out = {}
    for key, (a, b) in calls.items():
        a(), b()  # built and launched once before the first timed pair
        ms = [(timer(a), timer(b)) for _ in range(pairs)]
        out[key] = dict(pairs=ms, wins=sum(t_b < t_a for t_a, t_b in ms))
    return out


def measure_halo(torch, cs, timer, copy_gbs, times, outs):
    """K12 at convdiff@1M's row blocks (chip_smoke.check_halo_kernels'
    inputs), the same-bytes copy and K1 at n = 262,144."""
    from gmres_tpu_torch.io.synth import convection_diffusion_2d
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk
    from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
    from gmres_tpu_torch.ops.dia import from_csr
    from gmres_tpu_torch.parallel.halo import partition_halo

    H = partition_halo(convection_diffusion_2d(cs.NX, beta=2.0), RANKS)
    r, hl, hr, offs = H.rows_per_shard, H.halo_left, H.halo_right, H.offsets
    D = len(offs)
    rng = np.random.default_rng(10)
    for side, s in (("interior", 1), ("first", 0), ("last", RANKS - 1)):
        d64 = torch.tensor(H.data[s], device="cuda")
        x64 = torch.tensor(rng.random(r), device="cuda")
        l64 = torch.tensor(rng.random(hl) if s > 0 else np.zeros(hl), device="cuda")
        r64 = torch.tensor(rng.random(hr) if s < RANKS - 1 else np.zeros(hr), device="cuda")
        b64 = torch.tensor(rng.standard_normal(r), device="cuda")
        for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            sz = dt.itemsize
            data, x, left, right = (t.to(dt) for t in (d64, x64, l64, r64))
            key = f"{name} {side}"
            outs[f"halo_spmv {key} y"] = hk.dia_spmv_halo_cuda(data, offs, x, left, right).cpu()
            ms = timer(lambda: hk.dia_spmv_halo_cuda(data, offs, x, left, right))
            nbytes = (D + 2) * r * sz + (hl + hr) * sz
            times[f"halo_spmv {key}"] = dict(ms=ms, of_copy=_of_copy(nbytes, ms, copy_gbs))
            res, rsq, xsq = hk.dia_residual_halo_cuda(d64, offs, b64, x64, l64, r64, dt)
            outs[f"halo_residual {key} r"] = res.cpu()
            outs[f"halo_residual {key} sums"] = torch.stack([rsq, xsq]).cpu()
            ms = timer(lambda: hk.dia_residual_halo_cuda(d64, offs, b64, x64, l64, r64, dt))
            nbytes = (D + 3) * r * 8 + (hl + hr) * 8
            times[f"halo_residual {key}"] = dict(
                ms=ms, of_copy=_of_copy(nbytes, ms, copy_gbs),
                kernels=_kernels_a_call(torch, cs, lambda: hk.dia_residual_halo_cuda(
                    d64, offs, b64, x64, l64, r64, dt)))
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        nbytes = (D + 2) * r * dt.itemsize + (hl + hr) * dt.itemsize
        src = torch.ones(nbytes // 2 // dt.itemsize, dtype=dt, device="cuda")
        dst = torch.empty_like(src)
        ms = timer(lambda: dst.copy_(src))
        times[f"halo_copy {name}"] = dict(ms=ms, bytes=2 * src.numel() * dt.itemsize,
                                          of_copy=_of_copy(2 * src.numel() * dt.itemsize, ms,
                                                           copy_gbs))
    dia = from_csr(convection_diffusion_2d(512, beta=2.0))
    x_np = np.random.default_rng(11).random(dia.n_rows)
    for name, dt in (("float32", torch.float32), ("float64", torch.float64)):
        data = dia.data.to("cuda", dt)
        x = torch.tensor(x_np, dtype=dt, device="cuda")
        ms = timer(lambda: sk.dia_spmv_cuda(data, dia.offsets, x))
        nbytes = (len(dia.offsets) + 2) * dia.n_rows * dt.itemsize
        times[f"dia_spmv 262K {name}"] = dict(ms=ms, of_copy=_of_copy(nbytes, ms, copy_gbs),
                                              offsets=list(dia.offsets))


def measure_df64(torch, cs, timer, copy_gbs, times, outs):
    from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk

    Vh, Vl, wh, wl, u, _, _ = cs.df64_pair_basis(torch, N, 7)
    for rows in ROWS:
        ur = u.clone()
        ur[rows:] = 0
        nbytes = (2 * rows + 4) * 4 * N
        for kname, last in (("df_update_gram", "u2"), ("df_update_sumsq", "sumsq")):
            fn = getattr(dk, kname + "_cuda")
            wh1, wl1, z = fn(Vh, Vl, wh, wl, ur, rows)
            key = f"{kname} df64 rows {rows}"
            outs[f"{key} w1"] = torch.stack([wh1, wl1]).cpu()
            outs[f"{key} {last}"] = z.cpu()
            ms = timer(lambda: fn(Vh, Vl, wh, wl, ur, rows))
            times[key] = dict(ms=ms, of_copy=_of_copy(nbytes, ms, copy_gbs),
                              kernels=_kernels_a_call(
                                  torch, cs, lambda: fn(Vh, Vl, wh, wl, ur, rows)))
    del Vh, Vl, wh, wl, u


def compare(torch, a_path, b_path) -> int:
    sys.path.insert(0, ROOT)
    from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS

    a, b = torch.load(a_path), torch.load(b_path)
    equal = {k: bool(torch.equal(a[k], b[k])) for k in sorted(set(a) & set(b))}
    print(json.dumps({"compare": [a_path, b_path], "bit_equal": equal}), flush=True)
    # outputs a change may move (K2x2's u): the largest difference
    moved = {k: float((a[k].double() - b[k].double()).abs().max()) for k in equal
             if not equal[k]}
    kept = [k for k in equal if any(k.startswith(p + " ") and k.endswith(" " + s)
                                    for p, s in KEPT)]
    missing = [p for p in KEPT if not any(k.startswith(p[0] + " ") and k.endswith(" " + p[1])
                                          for k in kept)]
    missing += [f"axpy {sfx} x" for sfx in AXPY_FORMS.values() if f"axpy {sfx} x" not in kept]
    differ = [k for k in kept if not equal[k]]
    print(json.dumps({"kept_bits_differ": differ, "kept_missing": missing,
                      "max_abs_diff_of_others": {k: v for k, v in moved.items()
                                                 if k not in differ}}), flush=True)
    return 0 if kept and not differ and not missing else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=ROOT)
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--pairs", type=int)
    ap.add_argument("--parent")
    args = ap.parse_args()
    import torch

    if args.compare:
        return compare(torch, *args.compare)
    if args.pairs and not args.parent:
        ap.error("--pairs needs --parent DIR")
    if not torch.cuda.is_available():
        print("port_kernels: torch sees no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cs = _timer_module()
    if args.pairs:
        pairs = measure_pairs(torch, cs.Timer(torch), args.parent, args.pairs)
        print(json.dumps(dict(parent=args.parent, device=torch.cuda.get_device_name(0),
                              pairs=pairs)), flush=True)
        return 0
    sys.path.insert(0, os.path.abspath(args.checkout))
    copy_ms, copy_gbs = cs.copy_bandwidth(torch)
    timer = cs.Timer(torch)
    times, outs = {}, {}
    measure_sweeps(torch, cs, timer, copy_gbs, times, outs)
    measure_halo(torch, cs, timer, copy_gbs, times, outs)
    measure_df64(torch, cs, timer, copy_gbs, times, outs)
    measure_k1(torch, timer, copy_gbs, times, outs)
    measure_forms_kept(torch, timer, times, outs)
    if args.save:
        torch.save(outs, args.save)
    print(json.dumps(dict(checkout=args.checkout, device=torch.cuda.get_device_name(0),
                          copy_ms=copy_ms, copy_gb_per_s=copy_gbs, kernels=times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
