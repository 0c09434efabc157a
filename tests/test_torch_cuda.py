"""Kernels K1-K12 and K2x2 on the card against their plain PyTorch versions,
at small and ragged sizes (n not a multiple of the block, tile, slice or
segment; n below one tile; empty rows; a long row; n_cols != n_rows;
one-sided factors; identity tail segments; rows < m+1), K7 bit for bit
across grid sizes and forms, the df64 kernels K8-K11 and K4's pair mode
(K8 and the updated pair of K10/K11 bit for bit), K12 (a rank's halo DIA
block) in plain and residual modes at interior and boundary shards, and
small DIA, SELL, ILU, MGS, df64 and distributed (two gloo ranks sharing the
card; df64 too, with its sums over the ranks held to the one-device pair
gram; the block-Jacobi ILU on K1 and the per-rank SELL route on K5 with its
rank residual form) solves on the card against the same solves on the CPU; a bf16
ILU-Jacobi apply against the CPU's; the dtype
forms of the compressed-basis and bf16 tiers (K2, K2x2, K3's three modes,
K7, K4) against their plain versions at an aligned and a ragged n, K2's and
K3 GRAM's forms bit for bit across grids and one device kernel a call, and
compressed-basis and bf16 solves on the card against the CPU; K1's lane form
bit for bit against K1 lane by lane in both modes, and a batched solve whose
lanes have the counts of ``solve``.

These need an NVIDIA GPU with the CUDA toolkit: they carry the ``cuda``
marker and skip elsewhere.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

import gmres_tpu_torch
from gmres_tpu_torch.io.synth import convection_diffusion_2d, random_sparse, unstructured_mesh
from gmres_tpu_torch.ops import eft
from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
from gmres_tpu_torch.ops.cuda import df64_spmv_kernel as ds
from gmres_tpu_torch.ops.cuda import form_launch_counts, launch_counts, reset_launch_counts
from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS, GRAM2_FORMS, SWEEP_FORMS
from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
from gmres_tpu_torch.ops.cuda import orth_kernel as ok
from gmres_tpu_torch.ops.cuda import outer_kernel as ou
from gmres_tpu_torch.ops.cuda import sell_kernel as sl
from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.ops.reorder import permute_symmetric
from gmres_tpu_torch.ops.sell import SELLMatrix, sell_from_csr
from gmres_tpu_torch.precond import build as pbuild
from gmres_tpu_torch.precond.apply import apply_preconditioner
from gmres_tpu_torch.sparse import csr_from_coo

pytestmark = pytest.mark.cuda

# kernel vs plain: the same sums in another order (per-block partials, FMA)
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
DTYPES = pytest.mark.parametrize("dt", [torch.float32, torch.float64])


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(got, want, dt):
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= TOL[dt] * scale


@DTYPES
@pytest.mark.parametrize("nx", [7, 45])
def test_dia_spmv_and_residual(dt, nx):
    dia = from_csr(convection_diffusion_2d(nx, beta=2.0))
    data = dia.data.to("cuda", dt)
    rng = np.random.default_rng(nx)
    x = torch.tensor(rng.random(dia.n_rows), dtype=dt, device="cuda")
    _close(sk.dia_spmv_cuda(data, dia.offsets, x), sk.dia_spmv_plain(data, dia.offsets, x), dt)
    d64 = dia.data.to("cuda")
    b = torch.tensor(rng.standard_normal(dia.n_rows), device="cuda")
    x64 = x.double()
    got = sk.dia_residual_cuda(d64, dia.offsets, b, x64, dt)
    want = sk.dia_residual_plain(d64, dia.offsets, b, x64, dt)
    _close(got[0], want[0], torch.float64)
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g - w)) <= 1e-5 * float(w)


@DTYPES
@pytest.mark.parametrize("n,rows", [(5000, 1), (5000, 7), (1025, 31)])
def test_basis_sweeps(dt, n, rows):
    rng = np.random.default_rng(n + rows)
    V = torch.zeros((31, n), dtype=dt, device="cuda")
    V[:rows] = torch.tensor(rng.standard_normal((rows, n)), dtype=dt, device="cuda")
    w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    u = torch.zeros(31, dtype=dt, device="cuda")
    u[:rows] = torch.tensor(rng.standard_normal(rows), dtype=dt, device="cuda")
    _close(ok.gram_cuda(V, w, rows), ok.gram_plain(V, w, rows), dt)
    for got, want in zip(ok.update_gram_cuda(V, w, u, rows), ok.update_gram_plain(V, w, u, rows)):
        _close(got, want, dt)
    for got, want in zip(ok.update_sumsq_cuda(V, w, u, rows), ok.update_sumsq_plain(V, w, u, rows)):
        _close(got, want, dt)
    x = torch.tensor(rng.random(n), device="cuda")
    y = u[: max(rows - 1, 1)].contiguous()
    _close(ou.basis_axpy_cuda(x.clone(), V, y), ou.basis_axpy_plain(x.clone(), V, y), dt)


@DTYPES
@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 4096, 70_001, 2 ** 20 + 3])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "unaligned_base"])
def test_gram_one_launch_bits_independent_of_grid(dt, n, shift):
    # K2 against gram_plain at ragged n (rows 16-byte aligned only where n is
    # a multiple of the vector width) and at a V and w that start one value
    # past a 16-byte boundary; the bits repeat and do not depend on the grid
    m1 = 31
    rng = np.random.default_rng(n + shift)
    Vb = torch.tensor(rng.standard_normal(m1 * n + shift), dtype=dt, device="cuda")
    wb = torch.tensor(rng.standard_normal(n + shift), dtype=dt, device="cuda")
    V, w = Vb[shift:].view(m1, n), wb[shift:]
    for rows in (1, 7, 8, 9, 16, m1):
        reset_launch_counts()
        got = ok.gram_cuda(V, w, rows)
        assert launch_counts()["basis_gram"] == 1
        scale = ok.gram_plain(V.abs(), w.abs(), rows)
        assert float((got - ok.gram_plain(V, w, rows)).abs().max()) <= \
            TOL[dt] * float(scale.max())
        assert not got[rows:].any()
        grids = {ok.gram_cuda.grid}
        for per_sm in (1, 4, None):
            assert torch.equal(ok.gram_cuda(V, w, rows, blocks_per_sm=per_sm), got)
            grids.add(ok.gram_cuda.grid)
        assert n < 2 ** 20 or len(grids) > 1, grids  # more tiles than one grid has blocks


@pytest.mark.parametrize("n", [1, 3, 1023, 4097, 70_001, 2 ** 20 + 3])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "unaligned_base"])
def test_update_gram_one_launch_bits_independent_of_grid(n, shift, dt=torch.float32):
    # K3 GRAM in fp32 against update_gram_plain at ragged n and at a V and w
    # that start one value past a 16-byte boundary, at rows 1, 7, 31 and 256
    # (its stage's tile shrinks with rows): one launch, u2 zero past rows,
    # and the same bits on three grids
    m1 = 256
    rng = np.random.default_rng(n + shift)
    Vb = torch.tensor(rng.standard_normal(m1 * n + shift), dtype=dt, device="cuda")
    wb = torch.tensor(rng.standard_normal(n + shift), dtype=dt, device="cuda")
    V, w = Vb[shift:].view(m1, n), wb[shift:]
    u = torch.tensor(rng.standard_normal(m1) / 16, dtype=dt, device="cuda")
    for rows in (1, 7, 31, 256):
        reset_launch_counts()
        w1, u2 = ok.update_gram_cuda(V, w, u, rows)
        assert launch_counts()["basis_update_gram"] == 1
        pw, pu = ok.update_gram_plain(V, w, u, rows)
        sw = w.abs() + torch.mv(V[:rows].abs().t(), u[:rows].abs())
        assert float((w1 - pw).abs().max()) <= TOL[dt] * float(sw.max())
        scale = ok.gram_plain(V.abs(), sw, rows)
        assert float((u2 - pu).abs().max()) <= TOL[dt] * float(scale.max())
        assert not u2[rows:].any()
        grids = {ok.update_gram_cuda.grid}
        for per_sm in (1, 2, 3, None):
            a, b = ok.update_gram_cuda(V, w, u, rows, blocks_per_sm=per_sm)
            assert torch.equal(a, w1) and torch.equal(b, u2)
            grids.add(ok.update_gram_cuda.grid)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = ok.update_gram_plan(n, rows, V.element_size(), sms)
        assert plan.n_tiles <= 3 * sms or len(grids) >= 3, grids


@pytest.mark.parametrize("n", [1, 1023, 70_001, 2 ** 20 + 3])
def test_update_gram_fp64_bits_do_not_depend_on_its_occupancy_cap(n, monkeypatch):
    # K3 GRAM in fp64 (the one-row-at-a-time arithmetic, rows loaded a batch
    # at a time, block partials added by torch.sum) against
    # update_gram_plain at rows 1, 7, 31 and 256; the dynamic shared memory
    # that caps its blocks an SM changes no bit
    m1, dt = 256, torch.float64
    rng = np.random.default_rng(n)
    V = torch.tensor(rng.standard_normal((m1, n)), dtype=dt, device="cuda")
    w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    u = torch.tensor(rng.standard_normal(m1) / 16, dtype=dt, device="cuda")
    for rows in (1, 7, 31, 256):
        w1, u2 = ok.update_gram_cuda(V, w, u, rows)
        pw, pu = ok.update_gram_plain(V, w, u, rows)
        sw = w.abs() + torch.mv(V[:rows].abs().t(), u[:rows].abs())
        assert float((w1 - pw).abs().max()) <= TOL[dt] * float(sw.max())
        assert float((u2 - pu).abs().max()) <= TOL[dt] * float(ok.gram_plain(V.abs(), sw, rows).max())
        assert not u2[rows:].any()
        for pad in (0, 100_000, 200_000):
            monkeypatch.setattr(ok, "UG_F64_PAD", pad)
            a, b = ok.update_gram_cuda(V, w, u, rows)
            assert torch.equal(a, w1) and torch.equal(b, u2)


def test_update_gram_w_keeps_the_one_row_at_a_time_bits():
    # w' = w - sum_j u_j V[j,:]: per column the combination from 0 with one
    # fmadd a row in ascending j, subtracted once, as K3 SUMSQ (the
    # one-row-at-a-time kernel K3 GRAM was a mode of) computes it
    for dt in (torch.float32, torch.float64):
        rng = np.random.default_rng(5)
        n, rows = 70_001, 31
        V = torch.tensor(rng.standard_normal((rows, n)), dtype=dt, device="cuda")
        w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
        u = torch.tensor(rng.standard_normal(rows), dtype=dt, device="cuda")
        w1, _ = ok.update_gram_cuda(V, w, u, rows)
        w2, _ = ok.update_sumsq_cuda(V, w, u, rows)
        assert torch.equal(w1, w2)


def _one_call(name):
    """The wrapper call whose device kernels a test counts, on its inputs
    ("gram:<form>", "gram2:<form>" and "update_gram:<form>" for the dtype
    forms)."""
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk

    if name.startswith("dia_residual_lanes:") or name == "dia_residual":
        n, offs = 1 << 20, (-1024, -1, 0, 1, 1024)
        s = int(name.split(":")[1]) if ":" in name else 1
        data = torch.randn((5, n), dtype=torch.float64, device="cuda")
        X, B = (torch.randn((s, n), dtype=torch.float64, device="cuda") for _ in range(2))
        if ":" in name:
            return lambda: sk.dia_residual_lanes_cuda(data, offs, B, X, torch.float32)
        return lambda: sk.dia_residual_cuda(data, offs, B[0], X[0], torch.float32)
    if ":" in name:
        kernel, form = name.split(":")
        vt, wt = next(k for k, v in SWEEP_FORMS.items() if v == form)
        V = torch.randn((31, 1 << 20), device="cuda").to(vt)
        w, u = torch.randn(1 << 20, device="cuda").to(wt), torch.randn(31, device="cuda").to(wt)
        if kernel == "gram":
            return lambda: ok.gram_cuda(V, w, 31)
        if kernel == "gram2":
            w1 = V[30].to(wt)
            return lambda: ok.gram2_cuda(V, w, w1, 31)
        return lambda: ok.update_gram_cuda(V, w, u, 31)

    if name == "update_gram":
        V, w, u = torch.randn((31, 1 << 20), device="cuda"), torch.randn(
            1 << 20, device="cuda"), torch.randn(31, device="cuda")
        return lambda: ok.update_gram_cuda(V, w, u, 31)
    if name == "dia_residual_halo":
        r, offs = 1 << 18, (-1024, -1, 0, 1, 1024)
        data = torch.randn((5, r), dtype=torch.float64, device="cuda")
        x, b = (torch.randn(r, dtype=torch.float64, device="cuda") for _ in range(2))
        edge = torch.randn(1024, dtype=torch.float64, device="cuda")
        return lambda: hk.dia_residual_halo_cuda(data, offs, b, x, edge, edge, torch.float32)
    Vh, Vl, wh, wl, u, _, _ = _df_pairs(1 << 20, 31, 0, 1)
    return lambda: dk.df_update_gram_cuda(Vh, Vl, wh, wl, u, 31)


def _profile(name):
    """Names of the device kernels one call of `_one_call(name)` launches
    (torch.profiler, after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn = _one_call(name)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _device_kernels(name):
    """_profile(name) in a fresh process.  Late in a long process the card's
    profiler has recorded no device activity at all, for any kernel; a fresh
    process whose kernels are loaded before its one profiler cycle records
    them.  No device kernel at all fails: a call launches at least one."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import json, sys; sys.path[:0] = [{os.path.dirname(here)!r}, {here!r}]; "
            f"import test_torch_cuda as t; print(json.dumps(t._profile({name!r})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = json.loads(proc.stdout.strip().splitlines()[-1])
    assert names, "torch.profiler recorded no device kernel"
    return names


def test_ticket_counter_refuses_a_second_stream():
    # K2, K3 GRAM, K10 and K12's residual mode share one ticket counter a
    # card, made on the first stream that launches one of them; a launch from
    # any other stream raises before it reaches the card
    V = torch.randn((4, 1000), device="cuda")
    w = torch.randn(1000, device="cuda")
    ok.gram_cuda(V, w, 4)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side), pytest.raises(RuntimeError, match="ticket counter"):
        ok.gram_cuda(V, w, 4)
    ok.gram_cuda(V, w, 4)


def test_update_gram_is_one_device_kernel():
    names = _device_kernels("update_gram")
    assert len(names) == 1 and "update_gram" in names[0], names


def _basis(dt, n, rows, m1=31, seed=0):
    """V (m1, n) with its first `rows` rows orthonormal and the rest zero,
    and a vector w, on the card."""
    rng = np.random.default_rng(seed + n + rows)
    V = torch.zeros((m1, n), dtype=dt, device="cuda")
    q = np.linalg.qr(rng.standard_normal((n, rows)))[0].T
    V[:rows] = torch.tensor(q, dtype=dt, device="cuda")
    w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    return V, w


@DTYPES
@pytest.mark.parametrize("n,rows", [(700, 5), (1024, 31), (5000, 1), (5000, 7), (70001, 16)])
def test_gram2_and_plain_update(dt, n, rows):
    # n below one tile (700), exactly one (1024), ragged (5000, 70001)
    V, w = _basis(dt, n, rows)
    w1 = torch.roll(w, 3)
    got, want = ok.gram2_cuda(V, w, w1, rows), ok.gram2_plain(V, w, w1, rows)
    assert got.shape == want.shape == (31, 2)
    for got, want in zip(got.unbind(1), want.unbind(1)):
        _close(got, want, dt)
        assert not got[rows:].any()
    u = torch.zeros(31, dtype=dt, device="cuda")
    u[:rows] = torch.arange(1, rows + 1, dtype=dt, device="cuda") / rows
    _close(ok.update_cuda(V, w, u, rows), ok.update_plain(V, w, u, rows), dt)


# K2x2's and K4's shapes: convdiff@1M's n, an odd n, and n = 1M with V
# (and K2x2's vectors, K4's x) starting one value past a 16-byte boundary
SHAPES = pytest.mark.parametrize("n,shift", [(2 ** 20, 0), (100_003, 0), (2 ** 20, 1)],
                                 ids=["1M", "odd", "offset"])


def _shifted(rng, shape, dt, shift, scale=1.0):
    """A tensor of N(0, scale^2) entries that starts `shift` values into its
    buffer (V sliced at an offset: contiguous, its rows not 16-byte
    aligned)."""
    size = int(np.prod(shape))
    buf = torch.tensor(rng.standard_normal(size + shift) * scale, dtype=dt, device="cuda")
    return buf[shift:].view(shape)


@pytest.mark.parametrize("form", sorted(GRAM2_FORMS.values()))
@SHAPES
def test_gram2_bit_equal_to_gram(form, n, shift):
    # K2x2 is K2's kernel with two vectors: u0 and u1 each have the bits of
    # K2's u for that vector, in every form, aligned or not, on every grid,
    # in one launch, zero past rows
    vt, wt = next(k for k, v in GRAM2_FORMS.items() if v == form)
    rng = np.random.default_rng(n + shift)
    V = _shifted(rng, (31, n), vt, shift, 1 / np.sqrt(n))
    w0 = _shifted(rng, (n,), wt, shift)
    for rows in (1, 7, 16, 31):
        w1 = V[rows - 1].to(wt)
        reset_launch_counts()
        u = ok.gram2_cuda(V, w0, w1, rows)
        assert launch_counts()["basis_gram2"] == 1 and form_launch_counts()["basis_gram2"] == {
            form: 1}
        assert u.shape == (31, 2) and u.is_contiguous() and u.dtype == wt
        assert not u[rows:].any()
        assert torch.equal(u[:, 0], ok.gram_cuda(V, w0, rows))
        assert torch.equal(u[:, 1], ok.gram_cuda(V, w1.contiguous(), rows))
        for per_sm in (1, 3, 4):
            assert torch.equal(ok.gram2_cuda(V, w0, w1, rows, blocks_per_sm=per_sm), u), per_sm


@pytest.mark.parametrize("form", sorted(GRAM2_FORMS.values()))
def test_gram2_is_one_device_kernel(form):
    names = _device_kernels(f"gram2:{form}")
    assert len(names) == 1 and "basis_gram_kernel" in names[0], names


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_icwy_step_on_card_sums_u_and_l_in_one_collective(dt):
    # the distributed ICWY step passes K2x2's (m+1, 2) output to the
    # collective as it is: the same h, w', ||w'||^2 and L as summing
    # torch.stack([u, l]) (a stand-in two-rank sum: fixed partials added)
    from gmres_tpu_torch.ops.orth import mgs_lowsync_step

    class TwoRankSum:
        def __init__(self):
            self.rng = np.random.default_rng(5)

        def all_reduce_sum(self, t):
            return t + torch.tensor(self.rng.standard_normal(tuple(t.shape)), dtype=t.dtype,
                                    device=t.device)

    V, w = _basis(dt, 70_001, 6)
    k = 5
    L = torch.tril(V @ V.T, diagonal=-1)
    L[k:] = 0
    got = mgs_lowsync_step(V, k, w, L.clone(), TwoRankSum())
    old = TwoRankSum()
    pair = [ok.gram_cuda(V, w, k + 1), ok.gram_cuda(V, V[k], k + 1)]
    u, ell = old.all_reduce_sum(torch.stack(pair, dim=1)).unbind(1)
    Lt = L.clone()
    Lt[k, :k] = ell[:k]
    h = torch.linalg.solve_triangular(Lt, u.unsqueeze(1), upper=False,
                                      unitriangular=True).squeeze(1)
    w2, ss = ok.update_sumsq_cuda(V, w, h, k + 1)
    for g, w_ in zip(got, (h, w2, old.all_reduce_sum(ss), Lt)):
        assert torch.equal(g, w_)


@pytest.mark.parametrize("form", sorted(AXPY_FORMS.values()))
@SHAPES
def test_basis_axpy_every_form_and_grid(form, n, shift):
    # K4 in all eight forms against basis_axpy_plain elementwise (the sums
    # in another order: the accumulation dtype's tolerance of the scale, an
    # fp32 x 2e-5, a bf16 increment one bf16 ulp more), the same bits on
    # the persistent grid and on one block a tile, V and x at an offset too
    vt, yt, xt = next(k for k, v in AXPY_FORMS.items() if v == form)
    rng = np.random.default_rng(n + shift)
    V = _shifted(rng, (31, n), vt, shift, 1 / np.sqrt(n))
    x = _shifted(rng, (n,), xt, shift)
    y = torch.tensor(rng.standard_normal(30), dtype=yt, device="cuda")
    reset_launch_counts()
    got = ou.basis_axpy_cuda(x.clone(), V, y)
    assert form_launch_counts()["basis_axpy"] == {form: 1}
    want = ou.basis_axpy_plain(x.clone(), V, y)
    inc = torch.promote_types(yt, vt)
    scale = x.abs().double() + torch.mv(V[:30].double().abs().t(), y.double().abs())
    bound = (FORM_TOL[_acc(inc)] if inc != torch.float32 or xt != torch.float32 else 2e-5) \
        * float(scale.max())
    if inc == torch.bfloat16:
        bound = bound + BF16_ULP * ou.basis_axpy_plain(torch.zeros_like(x), V, y).double().abs()
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float(err.max())
    for per_sm in (0, 1, 4):
        assert torch.equal(ou.basis_axpy_cuda(x.clone(), V, y, blocks_per_sm=per_sm), got), per_sm


@DTYPES
@pytest.mark.parametrize("n,rows", [(700, 5), (1024, 31), (5000, 1), (5000, 7), (70001, 16),
                                    (300_001, 31)])
def test_mgs_kernel(dt, n, rows):
    V, w = _basis(dt, n, rows)
    got = mk.mgs_cuda(V, w, rows)
    want = mk.mgs_plain(V, w, rows)
    for g, p in zip(got, want):
        _close(g, p, dt)
    assert not got[0][rows:].any()
    # w' is orthogonal to the live rows
    assert float((V[:rows] @ got[1]).abs().max()) <= TOL[dt] * 10 * float(got[2])


@DTYPES
@pytest.mark.parametrize("n", [300_001, 2 ** 20])
def test_mgs_kernel_bit_equal_across_grids_and_forms(dt, n):
    # 293 tiles in 147 groups of 2: one block per SM holds 4 tiles a block
    # (74 blocks), the resident grid 2 a block (147 blocks); at 2^20, 1024
    # tiles in 256 groups of 4: 8 tiles a block (128 blocks) or 4 (256); the
    # L2 form keeps w in memory and takes the groups grid-stride; each
    # grid awaits a row's partials both ways
    V, w = _basis(dt, n, 31, seed=1)
    runs = []
    for per_sm, tiles_max in ((1, 8), (0, 8), (2, 8), (0, 0), (1, 0)):
        for exchange in (mk.SYNC, mk.POLL):  # a grid.sync() or polling the slots
            runs.append((mk.mgs_cuda(V, w, 31, blocks_per_sm=per_sm,
                                     max_register_tiles=tiles_max, exchange=exchange),
                         mk.mgs_cuda.grid))
    grids = {g for _, g in runs}
    assert len(grids) >= (4 if n < 2 ** 20 else 3), grids  # fp64 fits one 4-tile block an SM
    ref = runs[0][0]
    for out, grid in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, ref)), grid


def test_wrappers_refuse_what_the_kernels_do_not_take():
    V = torch.zeros((4, 100), device="cuda")
    with pytest.raises(ValueError):
        ok.gram_cuda(V.cpu(), torch.zeros(100), 2)
    with pytest.raises(TypeError):  # an fp64 basis against fp32 vectors: no form
        ok.gram_cuda(V.double(), torch.zeros(100, device="cuda"), 2)
    with pytest.raises(ValueError):
        ok.gram_cuda(V, torch.zeros(200, device="cuda")[::2], 2)
    with pytest.raises(ValueError):
        ok.gram_cuda(V, torch.zeros(100, device="cuda"), 5)
    with pytest.raises(ValueError):
        mk.mgs_cuda(V, torch.zeros(100, device="cuda"), 5)
    with pytest.raises(TypeError):
        mk.mgs_cuda(V.half(), torch.zeros(100, device="cuda").half(), 2)
    with pytest.raises(ValueError):
        ok.gram2_cuda(V, torch.zeros(100, device="cuda"), torch.zeros(99, device="cuda"), 2)


def _sell_case(case):
    rng = np.random.default_rng(len(case))
    if case == "mesh":
        return unstructured_mesh(4096, run=8)
    if case == "ragged":  # n not a multiple of 32 or of the block
        return random_sparse(1001, row_nnz=5)
    n = 700
    if case == "empty_rows":  # every 3rd row and rows 64..191 store nothing
        keep = (np.arange(n) % 3 != 0) & ((np.arange(n) < 64) | (np.arange(n) >= 192))
        rows = np.repeat(np.flatnonzero(keep), 4)
    else:  # one long row
        rows = np.repeat(np.arange(n), np.where(np.arange(n) == 57, 300, 3))
    n_cols = 900 if case == "long_row" else n
    cols = rng.integers(0, n_cols, size=rows.size)
    return csr_from_coo(rows, cols, rng.standard_normal(rows.size), n_rows=n, n_cols=n_cols)


@DTYPES
@pytest.mark.parametrize("case", ["mesh", "ragged", "empty_rows", "long_row"])
def test_sell_spmv_and_residual(dt, case):
    A = _sell_case(case)
    S = sell_from_csr(A, max_padding=64.0).to("cuda")
    vals = S.vals.to(dt)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal(A.n_cols), dtype=dt, device="cuda")
    args = (vals, S.cols, S.slice_ptr)
    _close(sl.sell_spmv_cuda(*args, x, A.n_rows), sl.sell_spmv_plain(*args, x, A.n_rows), dt)
    if A.n_rows != A.n_cols:
        return
    # residual mode: the solver's fp64 outer operator, its norm demoted to dt
    b = torch.tensor(rng.standard_normal(A.n_rows), device="cuda")
    x64 = x.double()
    got = sl.sell_residual_cuda(S.vals, S.cols, S.slice_ptr, b, x64, dt)
    want = sl.sell_residual_plain(S.vals, S.cols, S.slice_ptr, b, x64, dt)
    _close(got[0], want[0], torch.float64)
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g - w)) <= 1e-5 * float(w)
    # an operator in dt itself (uniform fp32 in the 'single' mode)
    got = sl.sell_residual_cuda(vals, S.cols, S.slice_ptr, b.to(dt), x, dt)
    want = sl.sell_residual_plain(vals, S.cols, S.slice_ptr, b.to(dt), x, dt)
    _close(got[0], want[0], dt)


def test_sell_wrappers_refuse_what_the_kernel_does_not_take():
    S = sell_from_csr(random_sparse(100, row_nnz=4))
    x = torch.zeros(100, dtype=torch.float64)
    with pytest.raises(ValueError):
        sl.sell_spmv_cuda(S.vals, S.cols, S.slice_ptr, x, 100)
    with pytest.raises(ValueError):
        sl.sell_residual_cuda(S.vals, S.cols, S.slice_ptr, x, x, torch.float32)
    Sd = S.to("cuda")
    with pytest.raises(TypeError):
        sl.sell_spmv_cuda(Sd.vals, Sd.cols.long(), Sd.slice_ptr, x.cuda(), 100)
    with pytest.raises(ValueError):
        sl.sell_spmv_cuda(Sd.vals, Sd.cols, Sd.slice_ptr, x.cuda(), 200)


PATH_KERNELS = {"dia": {"dia_spmv", "dia_residual"}, "sell": {"sell_spmv", "sell_residual"}}
ILU_KERNELS = {"ilu_trisolve_fused", "ilu_trisolve_segmented"}
MGS_KERNELS = {"basis_mgs", "basis_gram2", "basis_update"}  # MGS and orth_steps != 2 only
DF64_KERNELS = {"dia_spmv_df64", "df_gram", "df_update_gram", "df_update_sumsq"}  # df64 only
DIST_KERNELS = {"dia_spmv_halo", "dia_residual_halo"}  # distributed halo DIA only


@pytest.mark.parametrize("fmt", ["dia", "sell"])
@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_solve_on_card_matches_cpu(mode, fmt):
    # each path launches its own SpMV kernels and the shared sweeps, and
    # not the other path's SpMV kernels nor, with no preconditioner, K6, nor
    # under CGSR the MGS kernels, nor outside the df64 tier K8-K11
    A = convection_diffusion_2d(32, beta=2.0) if fmt == "dia" else unstructured_mesh(4096, run=8)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth="cgsr",
        precond="identity", restart_length=30, tol=1e-8, max_restarts=80)
    assert isinstance(gmres_tpu_torch.stage(A, cfg), SELLMatrix) == (fmt == "sell")
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg)
    counts = launch_counts()
    other = (PATH_KERNELS["sell" if fmt == "dia" else "dia"] | ILU_KERNELS | MGS_KERNELS
             | DF64_KERNELS | DIST_KERNELS)
    assert all(counts[k] > 0 for k in counts if k not in other), counts
    assert all(counts[k] == 0 for k in other), counts
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.x.is_cuda and res.converged
    assert (res.restarts, res.total_iters) == (ref.restarts, ref.total_iters)
    xr = ref.x.numpy()
    tol = 1e-9 if mode == "baseline" else 1e-5
    assert np.linalg.norm(res.x.cpu().numpy() - xr) / np.linalg.norm(xr) <= tol


def _exact(nx, dt, n_seg=None, monkeypatch=None):
    """ExactILUDIAPrec of convdiff(nx) in dt on the card: fused, or split
    into n_seg segments in multiples of 1024 rows (budget: an n_seg-th of
    the working set of 4 bands and 5 vectors)."""
    if n_seg is not None:
        monkeypatch.setattr(pbuild, "_TRISOLVE_L2_BYTES", -(-9 * dt.itemsize * nx * nx // n_seg))
    M = pbuild.build_ilu_exact(convection_diffusion_2d(nx, beta=2.0), dt)
    assert isinstance(M, pbuild.ExactILUDIAPrec) and (M.seg > 0) == (n_seg is not None)
    return M.to("cuda")


def _k6(M, w, sync=None):
    """K6 (on M's level schedule; the fused form on the grid ``sync``) and
    its plain version on the same CUDA tensors."""
    args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u)
    if M.seg:
        steps = (M.steps_l_segs, M.steps_u_segs, M.seg)
        return tk.ilu_trisolve_segmented_cuda(*args, *steps, schedule=M.schedule), \
            tk.ilu_trisolve_segmented_plain(*args, *steps)
    return tk.ilu_trisolve_fused_cuda(*args, M.steps_l, M.steps_u, schedule=M.schedule,
                                      sync=sync), \
        tk.ilu_trisolve_fused_plain(*args, M.steps_l, M.steps_u)


@DTYPES
@pytest.mark.parametrize("nx,n_seg", [(7, None), (45, None), (45, 2), (60, 4), (60, 2)])
def test_ilu_trisolve(dt, nx, n_seg, monkeypatch):
    # n = 49, 2025, 3600: no multiple of the block; several segments with a
    # partial last one; the result repeats bit for bit and equals the plain
    # sweeps' bits (each row once from final inputs, every product and sum
    # rounded once as the torch ops round)
    M = _exact(nx, dt, n_seg, monkeypatch)
    w = torch.tensor(np.random.default_rng(nx).standard_normal(nx * nx), dtype=dt, device="cuda")
    got, want = _k6(M, w)
    _close(got, want, dt)
    assert torch.equal(got, want)
    assert torch.equal(_k6(M, w)[0], got)


@DTYPES
@pytest.mark.parametrize("nx,n_seg", [(64, 2), (256, 4), (512, 2)])
def test_ilu_trisolve_levels_same_bits_every_form_and_grid(dt, nx, n_seg, monkeypatch):
    # fused and segmented run one schedule; one block and cooperative
    # grids compute each row from the same inputs
    Mf = _exact(nx, dt)
    Ms = _exact(nx, dt, n_seg, monkeypatch)
    w = torch.tensor(np.random.default_rng(nx).standard_normal(nx * nx), dtype=dt, device="cuda")
    got, want = _k6(Mf, w)
    assert torch.equal(got, want)
    assert tk.ilu_trisolve_fused_cuda.grid == ("block", 1)  # widest level nx <= 1024
    assert torch.equal(_k6(Ms, w)[0], got)
    for sync in (("grid", 2), ("grid", 4), ("grid", 10_000)):
        assert torch.equal(_k6(Mf, w, sync)[0], got), sync
        assert tk.ilu_trisolve_fused_cuda.grid[0] == "grid"


def _random_bands(n, d, seed, dt):
    """Random strictly-lower and strictly-upper bands (d each, offsets in
    no particular order, about half of the stored values zero) and an
    inverse diagonal, on the CPU."""
    rng = np.random.default_rng(seed)
    offs_l = tuple(int(o) for o in -rng.choice(np.arange(1, n), size=d, replace=False))
    offs_u = tuple(int(o) for o in rng.choice(np.arange(1, n), size=d, replace=False))
    ld, ud = (torch.tensor(0.3 / d * rng.standard_normal((d, n)) * (rng.random((d, n)) < 0.5),
                           dtype=dt) for _ in range(2))
    invd = torch.tensor(1.0 / (2.0 + rng.random(n)), dtype=dt)
    return ld, ud, invd, offs_l, offs_u


@DTYPES
@pytest.mark.parametrize("n,d", [(300, 3), (1000, 17), (1500, 64)])
def test_ilu_trisolve_random_bands(dt, n, d):
    # up to 64 bands per triangle: past the 4 a thread prefetches
    ld, ud, invd, offs_l, offs_u = _random_bands(n, d, n + d, dt)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    ld, ud, invd, S = ld.cuda(), ud.cuda(), invd.cuda(), S.to("cuda")
    w = torch.tensor(np.random.default_rng(d).standard_normal(n), dtype=dt, device="cuda")
    args = (ld, ud, invd, w, offs_l, offs_u, S.nlev_l, S.nlev_u)
    got = tk.ilu_trisolve_fused_cuda(*args, schedule=S)
    assert torch.equal(got, tk.ilu_trisolve_fused_plain(*args))
    assert torch.equal(tk.ilu_trisolve_fused_cuda(*args, schedule=S, sync=("grid", 3)), got)
    with pytest.raises(TypeError):  # no schedule is built for a call
        tk.ilu_trisolve_fused_cuda(*args, schedule=None)


@DTYPES
@pytest.mark.parametrize("widest", [1, 100, 1025, 2048])
def test_ilu_trisolve_widest_levels_every_form(dt, widest):
    # levels of exactly `widest` rows (L offsets -widest, -widest - 1, U
    # the mirror, no stored zero): the picked form and every forced one
    # give the sweeps' bits and the level twin's
    n = 3 * widest + (widest + 1) // 2
    rng = np.random.default_rng(widest)
    ld, ud = (torch.tensor(0.2 * rng.standard_normal((2, n)) + 0.3, dtype=dt, device="cuda")
              for _ in range(2))
    invd = torch.tensor(1.0 / (2.0 + rng.random(n)), dtype=dt, device="cuda")
    offs_l, offs_u = (-widest, -widest - 1), (widest, widest + 1)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u).to("cuda")
    assert (S.width_l, S.width_u) == (widest, widest)
    w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    args = (ld, ud, invd, w, offs_l, offs_u, S.nlev_l, S.nlev_u)
    want = tk.ilu_trisolve_fused_plain(*args)
    assert torch.equal(tk.ilu_trisolve_levels_plain(S, w), want)
    assert torch.equal(tk.ilu_trisolve_fused_cuda(*args, schedule=S), want)
    assert tk.ilu_trisolve_fused_cuda.grid == tk.level_grid(widest)
    for sync in (("block", 1), ("grid", 2), ("grid", 3), ("grid", 10_000)):
        assert torch.equal(tk.ilu_trisolve_fused_cuda(*args, schedule=S, sync=sync), want), sync
        assert tk.ilu_trisolve_fused_cuda.grid[0] == sync[0]


@DTYPES
def test_ilu_trisolve_skips_a_stored_zero_band_as_its_twin(dt):
    # an inf read only through stored zero bands (convdiff's L band at -1 in
    # each grid row's first column): the kernel leaves those terms out, as
    # the level twin does, on one block and on a grid
    # (L alone: U's band at +1 would carry the inf over every row)
    nx = 64
    M = _exact(nx, dt)
    empty = torch.zeros((0, nx * nx), dtype=dt, device="cuda")
    ones = torch.ones(nx * nx, dtype=dt, device="cuda")
    S = tk.level_schedule(M.lower_bands, empty, ones, M.offs_l, ()).to("cuda")
    w = torch.tensor(np.random.default_rng(6).standard_normal(nx * nx), dtype=dt, device="cuda")
    w[nx - 1] = float("inf")
    args = (M.lower_bands, empty, ones, w, M.offs_l, (), M.steps_l, 1)
    want = tk.ilu_trisolve_levels_plain(S, w).view(nx, nx)
    assert torch.isfinite(want[:, :-1]).all() and not torch.isfinite(want[:, -1]).any()
    for sync in (None, ("grid", 3)):
        got = tk.ilu_trisolve_fused_cuda(*args, schedule=S, sync=sync).view(nx, nx)
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@DTYPES
@pytest.mark.parametrize("upper", [True, False], ids=["no_lower_bands", "no_upper_bands"])
def test_ilu_trisolve_one_sided(dt, upper):
    n, rng = 1000, np.random.default_rng(5)
    offs = (1, 7) if upper else (-7, -1)
    bands = torch.zeros((2, n), dtype=dt)
    for d, off in enumerate(offs):
        lo, hi = max(0, -off), min(n, n - off)
        bands[d, lo:hi] = torch.tensor(0.5 * rng.standard_normal(hi - lo), dtype=dt)
    invd = torch.tensor(1.0 / (2.0 + rng.random(n)), dtype=dt, device="cuda")
    w = torch.tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    empty = torch.zeros((0, n), dtype=dt, device="cuda")
    ld, ud = (empty, bands.cuda()) if upper else (bands.cuda(), empty)
    args = (ld, ud, invd, w, () if upper else offs, offs if upper else (), n, n)
    S = tk.level_schedule(*args[:3], *args[4:6]).to("cuda")
    _close(tk.ilu_trisolve_fused_cuda(*args, schedule=S), tk.ilu_trisolve_fused_plain(*args), dt)


@DTYPES
def test_ilu_trisolve_identity_tail_segments(dt, monkeypatch):
    # the factors widened by two zero-band segments of inverse diagonal 1,
    # one sweep each; w keeps its length (the wrapper pads it)
    M = _exact(45, dt, 2, monkeypatch)
    assert M.seg == 1024
    width = 4 * M.seg
    pad = width - M.inv_diag.shape[0]
    Mp = dataclasses.replace(
        M, lower_bands=torch.nn.functional.pad(M.lower_bands, (0, pad)),
        upper_bands=torch.nn.functional.pad(M.upper_bands, (0, pad)),
        inv_diag=torch.nn.functional.pad(M.inv_diag, (0, pad), value=1.0),
        steps_l_segs=M.steps_l_segs + (1, 1), steps_u_segs=M.steps_u_segs + (1, 1),
        schedule=None).to("cuda")  # the schedule of the widened bands
    w = torch.tensor(np.random.default_rng(3).standard_normal(45 * 45), dtype=dt, device="cuda")
    got, _ = _k6(Mp, w)
    assert got.shape == w.shape
    _close(got, _k6(M, w)[1], dt)


def test_red_black_factor_routes_to_sweeps():
    # 2 dependency levels per triangle: ILU-Jacobi sweeps, not K6
    nx = 32
    A = convection_diffusion_2d(nx, beta=2.0)
    ii, jj = np.divmod(np.arange(nx * nx), nx)
    perm = np.concatenate([np.flatnonzero((ii + jj) % 2 == 0), np.flatnonzero((ii + jj) % 2)])
    M = pbuild.build_ilu_exact(permute_symmetric(A, perm), torch.float32)
    assert isinstance(M, pbuild.ILUJacobiPrec) and M.steps == 2
    M = pbuild.sell_pack_factors(pbuild.optimize_precond_format(M))
    w = torch.tensor(np.random.default_rng(9).standard_normal(nx * nx), dtype=torch.float32)
    reset_launch_counts()
    got = apply_preconditioner(M.to("cuda"), w.cuda())
    assert all(launch_counts()[k] == 0 for k in ILU_KERNELS)
    _close(got.cpu(), apply_preconditioner(M, w), torch.float32)


def test_cuda_tensor_reaches_k6_or_raises(monkeypatch):
    M = _exact(20, torch.float32)
    w = torch.ones(400, device="cuda")
    reset_launch_counts()
    apply_preconditioner(M, w)
    assert launch_counts()["ilu_trisolve_fused"] == 1
    with pytest.raises(ValueError):  # factors on the CPU, w on the card
        apply_preconditioner(M.to("cpu"), w)
    args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u)
    with pytest.raises(TypeError):
        tk.ilu_trisolve_fused_cuda(*(a.half() for a in args[:4]), M.offs_l, M.offs_u,
                                   M.steps_l, M.steps_u, schedule=M.schedule)
    with pytest.raises(TypeError):  # the wrapper builds no schedule
        tk.ilu_trisolve_fused_cuda(*args, M.steps_l, M.steps_u, schedule=None)
    with pytest.raises(ValueError, match="short of"):  # fewer sweeps: not the exact solve
        tk.ilu_trisolve_fused_cuda(*args, M.steps_l, M.steps_u - 1, schedule=M.schedule)
    with pytest.raises(ValueError):  # step counts for another number of segments
        tk.ilu_trisolve_segmented_cuda(*args, (1,) * 399, (1,) * 399, 1, schedule=M.schedule)
    Ms = _exact(45, torch.float32, 2, monkeypatch)
    apply_preconditioner(Ms, torch.ones(2025, device="cuda"))
    assert launch_counts()["ilu_trisolve_segmented"] == 1
    short = tuple(s - 1 for s in Ms.steps_l_segs)
    with pytest.raises(ValueError, match="short of"):
        tk.ilu_trisolve_segmented_cuda(Ms.lower_bands, Ms.upper_bands, Ms.inv_diag,
                                       torch.ones(2025, device="cuda"), Ms.offs_l, Ms.offs_u,
                                       short, Ms.steps_u_segs, Ms.seg, schedule=Ms.schedule)


@pytest.mark.parametrize("precond", ["ilu", "ilu_jacobi"])
@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_ilu_solve_on_card_matches_cpu(mode, precond):
    # exact ILU through K6 (no K5); ILU-Jacobi through K1 on DIA factors
    A = convection_diffusion_2d(32, beta=2.0)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth="cgsr",
        precond=precond, jacobi_steps=3, restart_length=30, tol=1e-8, max_restarts=80)
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg)
    counts = launch_counts()
    assert counts["ilu_trisolve_fused"] > 0 if precond == "ilu" else counts["ilu_trisolve_fused"] == 0
    assert counts["dia_spmv"] > 0 and counts["sell_spmv"] == 0, counts
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.x.is_cuda and res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    x = res.x.cpu().numpy()
    backward = np.linalg.norm(b - A.to_scipy() @ x) / (
        np.linalg.norm(b) + np.linalg.norm(A.vals.numpy()) * np.linalg.norm(x))
    assert backward <= 1e-8


@pytest.mark.parametrize("lowsync", [False, True])
@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_mgs_solve_on_card_matches_cpu(mode, lowsync):
    # sequential MGS through K7 alone, ICWY through K2x2 and K3 SUMSQ;
    # neither launches K2, the other form's kernels or K3 plain
    A = convection_diffusion_2d(32, beta=2.0)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth="mgs",
        low_sync_mgs=lowsync, precond="identity", restart_length=30, tol=1e-8,
        max_restarts=80)
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg)
    counts = launch_counts()
    assert counts["basis_mgs"] == (0 if lowsync else res.total_iters), counts
    assert (counts["basis_gram2"] > 0) == lowsync, counts
    assert counts["basis_update_sumsq"] == (counts["basis_gram2"] if lowsync else 0), counts
    assert counts["basis_gram"] == counts["basis_update"] == 0, counts
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.x.is_cuda and res.converged
    assert (res.restarts, res.total_iters) == (ref.restarts, ref.total_iters)
    xr = ref.x.numpy()
    tol = 1e-9 if mode == "baseline" else 1e-5
    assert np.linalg.norm(res.x.cpu().numpy() - xr) / np.linalg.norm(xr) <= tol


@pytest.mark.parametrize("kw", [dict(policy="relres", restart_improvement=1e-2),
                                dict(policy="repeat", restart_improvement=1e-2),
                                dict(policy="orthloss", restart_improvement=1e-2),
                                dict(orth_steps=3)])
def test_policy_solve_on_card_matches_cpu(kw):
    A = convection_diffusion_2d(32, beta=2.0)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("mixed"), orth="cgsr",
        precond="identity", restart_length=30, tol=1e-8, max_restarts=80, **kw)
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg, record_history=True)
    counts = launch_counts()
    assert (counts["basis_update"] > 0) == ("orth_steps" in kw), counts
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu", record_history=True)
    assert [h["k"] for h in res.history] == [h["k"] for h in ref.history]
    assert (res.converged, res.restarts, res.total_iters) == (ref.converged, ref.restarts,
                                                              ref.total_iters)


# df64 kernel vs plain: the pair sums over n run in another order; hold them
# to the terms' magnitudes times 2^-46 (a pair carries ~2^-48)
DF_TOL = 2.0 ** -46


def _df_close(got, want, scale):
    assert float((got - want).abs().max()) <= DF_TOL * float(scale.abs().max())


def _df_basis(n, rows, m1=31, seed=0):
    """Pairs of V (m1, n) with `rows` orthonormal rows and the rest zero, of
    w, and u (fp64, zero past rows), on the card; with V and w in fp64."""
    V, w = _basis(torch.float64, n, rows, m1, seed)
    u = torch.zeros(m1, dtype=torch.float64, device="cuda")
    u[:rows] = V[:rows] @ w
    return (*eft.split_f64(V), *eft.split_f64(w), u, V, w)


@pytest.mark.parametrize("n", [1000, 300_001])
def test_dia_spmv_df64_bit_equal(n):
    rng = np.random.default_rng(n)
    offs = (-517, -1, 0, 1, 517)
    d64 = torch.tensor(rng.standard_normal((5, n)), device="cuda")
    x64 = torch.tensor(rng.standard_normal(n), device="cuda")
    dh, dl = eft.split_f64(d64)
    xh, xl = eft.split_f64(x64)
    got = ds.dia_spmv_df64_cuda(dh, dl, offs, xh, xl)
    want = ds.dia_spmv_df64_plain(dh, dl, offs, xh, xl)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    y64 = sk.dia_spmv_plain(d64, offs, x64)
    _df_close(eft.merge_f64(*got), y64, sk.dia_spmv_plain(d64.abs(), offs, x64.abs()))


@pytest.mark.parametrize("n", [1000, 300_001])
@pytest.mark.parametrize("rows", [1, 16, 31])
def test_df64_sweeps(n, rows):
    Vh, Vl, wh, wl, u, V, w = _df_basis(n, rows, seed=rows)
    absV, absw = V.abs(), w.abs()
    got = dk.df_gram_cuda(Vh, Vl, wh, wl, rows)
    _df_close(got, dk.df_gram_plain(Vh, Vl, wh, wl, rows), absV @ absw)
    assert not got[rows:].any()
    for fn in ("df_update_gram", "df_update_sumsq"):
        gh, gl, gs = getattr(dk, fn + "_cuda")(Vh, Vl, wh, wl, u, rows)
        ph, pl, ps = getattr(dk, fn + "_plain")(Vh, Vl, wh, wl, u, rows)
        # the update pass is the plain version's chain, bit for bit
        assert torch.equal(gh, ph) and torch.equal(gl, pl)
        sw = absw + u.abs() @ absV
        _df_close(gs, ps, absV @ sw if fn == "df_update_gram" else (sw * sw).sum())
    x = torch.tensor(np.random.default_rng(rows).random(n), device="cuda")
    y = u[:rows].contiguous()
    got = ou.basis_axpy_pair_cuda(x.clone(), Vh, Vl, y)
    want = ou.basis_axpy_pair_plain(x.clone(), Vh, Vl, y)
    _df_close(got, want, x.abs() + y.abs() @ absV[:rows])


def test_df64_wrappers_refuse_what_the_kernels_do_not_take():
    Vh = torch.zeros((4, 100), device="cuda")
    w = torch.zeros(100, device="cuda")
    u = torch.zeros(4, dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):  # an fp64 basis is not a pair
        dk.df_gram_cuda(Vh.double(), Vh.double(), w, w, 2)
    with pytest.raises(ValueError):  # on the CPU
        dk.df_gram_cuda(Vh.cpu(), Vh.cpu(), w.cpu(), w.cpu(), 2)
    with pytest.raises(ValueError):  # rows past the basis
        dk.df_update_sumsq_cuda(Vh, Vh, w, w, u, 5)
    with pytest.raises(TypeError):  # u must be fp64
        dk.df_update_gram_cuda(Vh, Vh, w, w, u.float(), 2)
    with pytest.raises(ValueError):  # a strided vector
        dk.df_gram_cuda(Vh, Vh, torch.zeros(200, device="cuda")[::2], w, 2)
    with pytest.raises(TypeError):
        ds.dia_spmv_df64_cuda(Vh.double(), Vh.double(), (0, 1, 2, 3), w, w)
    with pytest.raises(ValueError):  # lo bands of another shape
        ds.dia_spmv_df64_cuda(Vh, Vh[:3], (0, 1, 2, 3), w, w)
    with pytest.raises(TypeError):  # the iterate must be fp64
        ou.basis_axpy_pair_cuda(w, Vh, Vh, u[:2])
    with pytest.raises(ValueError):  # more coefficients than basis rows
        ou.basis_axpy_pair_cuda(w.double(), Vh, Vh, torch.zeros(5, dtype=torch.float64,
                                                                 device="cuda"))


@pytest.mark.parametrize("orth,low_sync", [("cgs", None), ("cgsr", None), ("mgs", False),
                                           ("mgs", True)],
                         ids=["cgs", "cgsr", "mgs-sequential", "mgs-icwy"])
def test_df64_solve_on_card_matches_cpu(orth, low_sync):
    # the df64 cycle on DIA: K8 for the SpMV, K9-K11 for the sweeps, K4's
    # pair mode for the update, K1's residual mode for the outer residual;
    # none of K1's plain mode, K2, K3, K2x2 or K7
    A = convection_diffusion_2d(32, beta=2.0)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64"), orth=orth,
        low_sync_mgs=low_sync, precond="identity", restart_length=30, tol=1e-8,
        max_restarts=80)
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg)
    counts = launch_counts()
    assert counts["dia_spmv_df64"] == res.total_iters and counts["df_gram"] > 0, counts
    assert counts["df_update_sumsq"] > 0 and counts["dia_residual"] > 0, counts
    assert (counts["df_update_gram"] > 0) == (orth == "cgsr"), counts
    assert counts["basis_axpy"] == res.restarts, counts
    idle = {"dia_spmv", "basis_gram", "basis_update_gram", "basis_update_sumsq",
            "basis_update", "basis_gram2", "basis_mgs", "sell_spmv", "sell_residual"}
    assert all(counts[k] == 0 for k in idle | ILU_KERNELS), counts
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.x.is_cuda and res.converged
    assert (res.restarts, res.total_iters) == (ref.restarts, ref.total_iters)
    xr = ref.x.numpy()
    assert np.linalg.norm(res.x.cpu().numpy() - xr) / np.linalg.norm(xr) <= 1e-10


@DTYPES
@pytest.mark.parametrize("r,hl,hr", [(1000, 0, 0), (1000, 128, 0), (70001, 128, 128),
                                     (70001, 256, 128)])
@pytest.mark.parametrize("side", ["interior", "first", "last"])
def test_dia_halo_spmv_and_residual(dt, r, hl, hr, side):
    # K12 over a block of r rows and received edges of hl and hr values (the
    # first and last ranks receive zeros on their open side); the outer
    # offsets reach to the ends of the edges, or past the block where an
    # edge is empty
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk

    offsets = (-max(hl, 2), -1, 0, 1, max(hr, 2))
    rng = np.random.default_rng(r + hl + hr)
    data = torch.tensor(rng.standard_normal((len(offsets), r)), dtype=dt, device="cuda")
    x = torch.tensor(rng.standard_normal(r), dtype=dt, device="cuda")
    left = torch.tensor(rng.standard_normal(hl), dtype=dt, device="cuda")
    right = torch.tensor(rng.standard_normal(hr), dtype=dt, device="cuda")
    if side == "first":
        left.zero_()
    elif side == "last":
        right.zero_()
    reset_launch_counts()
    _close(hk.dia_spmv_halo_cuda(data, offsets, x, left, right),
           hk.dia_spmv_halo_plain(data, offsets, x, left, right), dt)
    d64, x64, l64, r64 = (t.double() for t in (data, x, left, right))
    b = torch.tensor(rng.standard_normal(r), device="cuda")
    got = hk.dia_residual_halo_cuda(d64, offsets, b, x64, l64, r64, dt)
    want = hk.dia_residual_halo_plain(d64, offsets, b, x64, l64, r64, dt)
    _close(got[0], want[0], torch.float64)
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g - w)) <= 1e-5 * float(w)
    assert launch_counts()["dia_spmv_halo"] == launch_counts()["dia_residual_halo"] == 1


def test_dia_halo_wrappers_refuse_what_the_kernel_does_not_take():
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk

    data = torch.ones((3, 64), device="cuda")
    x, edge = torch.ones(64, device="cuda"), torch.ones(8, device="cuda")
    with pytest.raises(TypeError):
        hk.dia_spmv_halo_cuda(data.half(), (-1, 0, 1), x.half(), edge.half(), edge.half())
    with pytest.raises(ValueError):  # an edge on the CPU
        hk.dia_spmv_halo_cuda(data, (-1, 0, 1), x, edge.cpu(), edge)
    with pytest.raises(ValueError):  # x of the wrong length
        hk.dia_spmv_halo_cuda(data, (-1, 0, 1), x[:63], edge, edge)
    with pytest.raises(ValueError):  # offsets do not match the bands
        hk.dia_spmv_halo_cuda(data, (-1, 0), x, edge, edge)


def _halo_case(r, offsets, hl, hr, P, s, seed):
    """A DIA matrix of P shards of r rows whose bands are zero wherever
    shard s's rows reach past its window [s r - hl, (s+1) r + hr) (and past
    the matrix), with x and b; on the card, in fp64: the whole matrix, x and
    b, and shard s's bands, block of x, edges (zeros past the matrix) and b
    as fresh tensors."""
    rng = np.random.default_rng(seed)
    N, lo, hi = P * r, s * r, (s + 1) * r
    data = rng.standard_normal((len(offsets), N))
    rows = np.arange(N)
    own = (rows >= lo) & (rows < hi)
    for d, off in enumerate(offsets):
        j = rows + off
        data[d, (j < 0) | (j >= N) | (own & ((j < lo - hl) | (j >= hi + hr)))] = 0.0
    x, b = rng.standard_normal(N), rng.standard_normal(N)
    left, right = np.zeros(hl), np.zeros(hr)
    tail = x[max(0, lo - hl):lo]
    left[hl - tail.size:] = tail
    head = x[hi:hi + hr]
    right[:head.size] = head
    glob = [torch.tensor(a, device="cuda") for a in (data, x, b)]
    shard = [torch.tensor(np.ascontiguousarray(a), device="cuda")
             for a in (data[:, lo:hi], x[lo:hi], left, right)]
    return glob, shard, torch.tensor(b[lo:hi], device="cuda"), (lo, hi)


_D5 = (-64, -1, 0, 1, 64)
_D27 = tuple(sorted({0, -1, 1, *range(-700, 701, 53)}))[:27]
HALO_CASES = [
    # r, offsets, hl, hr, ranks, shard
    *[(4096, _D5, 64, 64, 4, s) for s in (1, 0, 3)],           # aligned r
    *[(4098, _D5, 64, 64, 4, s) for s in (1, 0, 3)],           # r % 4 == 2
    *[(70_001, (-300, -1, 0, 1, 300), 300, 300, 3, s) for s in (1, 0, 2)],  # ragged
    *[(5000, (-70, -1, 0, 1, 70), 50, 40, 3, s) for s in (1, 0, 2)],  # edges short of |off|
    *[(8192, _D27, 700, 700, 3, s) for s in (1, 0, 2)],        # D = 27
    (10_000, _D5, 0, 0, 1, 0),                                  # a single shard
    (1000, (-1024, -1, 0, 1, 1024), 1000, 1000, 3, 1),         # r < max|off|
]


@DTYPES
@pytest.mark.parametrize("r,offsets,hl,hr,P,s", HALO_CASES,
                         ids=[f"r{c[0]}-D{len(c[1])}-h{c[2]},{c[3]}-P{c[4]}-s{c[5]}"
                              for c in HALO_CASES])
def test_dia_halo_bit_equal_to_k1_rows(dt, r, offsets, hl, hr, P, s):
    # K12 on shard s (interior, first, last or the only one) against K1 over
    # the whole matrix, edges taken from the global x: y bit for bit;
    # residual mode's r bit for bit against K1's residual mode, its sums of
    # squares against the plain version; one launch each
    from gmres_tpu_torch.ops.cuda import halo_kernel as hk

    assert len(offsets) in (5, 27)
    (A, x, b), shard64, bs, (lo, hi) = _halo_case(r, offsets, hl, hr, P, s, r + s)
    data, xs, left, right = (t.to(dt) for t in shard64)
    want = sk.dia_spmv_cuda(A.to(dt), offsets, x.to(dt))[lo:hi]
    reset_launch_counts()
    got = hk.dia_spmv_halo_cuda(data, offsets, xs, left, right)
    assert launch_counts()["dia_spmv_halo"] == 1
    assert torch.equal(got, want), float((got - want).abs().max())
    _close(got, hk.dia_spmv_halo_plain(data, offsets, xs, left, right), dt)
    d64, x64, l64, r64 = shard64
    r1 = sk.dia_residual_cuda(A, offsets, b, x, dt)[0][lo:hi]
    plain = hk.dia_residual_halo_plain(d64, offsets, bs, x64, l64, r64, dt)
    got = hk.dia_residual_halo_cuda(d64, offsets, bs, x64, l64, r64, dt)
    assert torch.equal(got[0], r1)
    tol = 1e-5 if dt == torch.float32 else 1e-12
    for g, w in zip(got[1:], plain[1:]):
        assert abs(float(g - w)) <= tol * float(w)


def test_dia_halo_residual_is_one_device_kernel():
    names = _device_kernels("dia_residual_halo")
    assert len(names) == 1 and "dia_spmv_kernel" in names[0], names  # K1's kernel


def _df_pairs(n, m1, shift, seed):
    """Vh, Vl (m1, n), wh, wl starting `shift` words past a 16-byte boundary,
    u (m1,) fp64; with V and w in fp64."""
    rng = np.random.default_rng(seed)
    V = torch.tensor(rng.standard_normal((m1, n)) / np.sqrt(n), device="cuda")
    w = torch.tensor(rng.standard_normal(n), device="cuda")
    u = torch.tensor(rng.standard_normal(m1), device="cuda")
    out = []
    for t in (*eft.split_f64(V), *eft.split_f64(w)):
        buf = torch.empty(t.numel() + shift, dtype=torch.float32, device="cuda")
        view = buf[shift:].view(t.shape)
        view.copy_(t)
        out.append(view)
    return (*out, u, V, w)


@pytest.mark.parametrize("n", [1, 1023, 4096, 70_001, 2 ** 20, 2 ** 20 + 3])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "unaligned_base"])
def test_df_update_gram_one_launch_bits_independent_of_grid(n, shift):
    # K10 against df_update_gram_plain at rows 1, 7, 16, 31 and 256 (a
    # 256-row basis up to n = 70,001, 31 rows beyond): one launch, w' bit for
    # bit, u2 within 2^-46 and zero past rows, the same bits on three grids
    m1 = 256 if n <= 70_001 else 31
    Vh, Vl, wh, wl, u, V, w = _df_pairs(n, m1, shift, n + shift)
    absV = V.abs()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in (r for r in (1, 7, 16, 31, 256) if r <= m1):
        ur = u.clone()
        ur[rows:] = 0
        reset_launch_counts()
        gh, gl, gu = dk.df_update_gram_cuda(Vh, Vl, wh, wl, ur, rows)
        assert launch_counts()["df_update_gram"] == 1
        ph, pl, pu = dk.df_update_gram_plain(Vh, Vl, wh, wl, ur, rows)
        assert torch.equal(gh, ph) and torch.equal(gl, pl)
        _df_close(gu, pu, absV @ (w.abs() + ur.abs() @ absV))
        assert not gu[rows:].any()
        grids = {dk.df_update_gram_cuda.grid}
        for per_sm in (1, 2, 3):
            a = dk.df_update_gram_cuda(Vh, Vl, wh, wl, ur, rows, blocks_per_sm=per_sm)
            assert all(torch.equal(p, q) for p, q in zip(a, (gh, gl, gu)))
            grids.add(dk.df_update_gram_cuda.grid)
        plan = dk.df_update_gram_plan(n, rows, sms)
        assert plan.n_tiles <= 3 * sms or len(grids) >= 3, grids


def test_df_update_gram_is_one_device_kernel():
    names = _device_kernels("df_update_gram")
    assert len(names) == 1 and "df_update_gram" in names[0], names


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_distributed_solve_on_card_matches_cpu(mode):
    # two gloo ranks sharing the card: the halo DIA blocks go through K12 in
    # both modes, and no rank launches K1, K5, K6, K7 or K8-K11
    from gmres_tpu_torch.ops.cuda._build import library
    from gmres_tpu_torch.parallel import launch
    from gmres_tpu_torch.parallel.dist_gmres import run_cases

    library()  # built here, so that the ranks load it
    A = convection_diffusion_2d(32, beta=2.0)
    b = A.to_scipy() @ gmres_tpu_torch.rand_vect(A.n_rows, 42)
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth="cgsr",
        precond="identity", restart_length=30, tol=1e-8, max_restarts=80)
    cases = [dict(A=A, b=b, cfg=cfg)]
    card = launch.spawn(run_cases, 2, args=(cases, "cuda"))
    cpu = launch.spawn(run_cases, 2, args=(cases, "cpu"))
    idle = (PATH_KERNELS["dia"] | PATH_KERNELS["sell"] | ILU_KERNELS | DF64_KERNELS
            | {"basis_mgs"})
    for (got,), (ref,) in zip(card, cpu):
        c = got["launches"]
        assert all(c[k] > 0 for k in DIST_KERNELS) and all(c[k] == 0 for k in idle), c
        assert got["converged"] and (got["restarts"], got["total_iters"]) == (
            ref["restarts"], ref["total_iters"])
        tol = 1e-9 if mode == "baseline" else 1e-5
        assert np.linalg.norm(got["x"] - ref["x"]) / np.linalg.norm(ref["x"]) <= tol


def test_distributed_df64_solve_on_card_matches_cpu():
    # two gloo ranks sharing the card, mode df64: a rank's block takes the
    # JAX package's plain-operator route (merge, K12 in fp64, split), its
    # sweeps K9-K11 with their fp64 sums added over the ranks, the update
    # K4's pair mode; no K1, K8 or native sweep.  The pair sums themselves:
    # a 31-row K9 gram over the ranks' blocks equals the one-device gram to
    # 2^-46 of its scale (the gram of |V| and |w|), and the same sum over
    # the ranks' hi parts does not
    from gmres_tpu_torch.ops.cuda._build import library
    from gmres_tpu_torch.parallel import launch
    from gmres_tpu_torch.parallel.dist_gmres import run_cases

    import torch_rank_helpers

    library()  # built here, so that the ranks load it
    A = convection_diffusion_2d(32, beta=2.0)
    b = A.to_scipy() @ gmres_tpu_torch.rand_vect(A.n_rows, 42)
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64"), orth="cgsr",
        precond="identity", restart_length=30, tol=1e-10, max_restarts=80)
    cases = [dict(A=A, b=b, cfg=cfg)]
    card = launch.spawn(run_cases, 2, args=(cases, "cuda"))
    cpu = launch.spawn(run_cases, 2, args=(cases, "cpu"))
    idle = PATH_KERNELS["dia"] | PATH_KERNELS["sell"] | ILU_KERNELS | {
        "dia_spmv_df64", "basis_gram", "basis_update_gram", "basis_update_sumsq",
        "basis_mgs", "basis_gram2", "basis_update"}
    for (got,), (ref,) in zip(card, cpu):
        c = got["launches"]
        assert all(c[k] > 0 for k in DIST_KERNELS | {"df_gram", "df_update_gram",
                                                     "df_update_sumsq", "basis_axpy"}), c
        assert all(c[k] == 0 for k in idle), c
        assert got["converged"] and (got["restarts"], got["total_iters"]) == (
            ref["restarts"], ref["total_iters"])
        assert np.linalg.norm(got["x"] - ref["x"]) / np.linalg.norm(ref["x"]) <= 1e-12
    n, rows = 70_001, 31
    for fp64_sum, hi_sum, whole, scale in launch.spawn(torch_rank_helpers.pair_sums, 2,
                                                       args=(n, rows, 5, "cuda")):
        scale = scale.max()
        assert np.abs(fp64_sum - whole).max() <= DF_TOL * scale
        assert np.abs(hi_sum - whole).max() > 2.0 ** -40 * scale


@DTYPES
@pytest.mark.parametrize("rank,ranks", [(0, 2), (1, 2), (3, 4)])
def test_sell_residual_rank_form(dt, rank, ranks):
    # K5's rank form (the per-rank SELL route's outer residual): a rank's
    # rows with global columns, x gathered, ||x||^2 over the rank's rows;
    # elementwise against its plain twin
    from gmres_tpu_torch.parallel.dist_gmres import sell_rows_per
    from gmres_tpu_torch.sparse import csr_from_arrays

    A = unstructured_mesh(20_000, jitter=8, seed=3)
    r = sell_rows_per(A.n_rows, ranks)
    rp, ci, v = A.numpy_arrays()
    lo, hi = min(rank * r, A.n_rows), min((rank + 1) * r, A.n_rows)
    rows = np.full(r + 1, rp[hi] - rp[lo])
    rows[:hi - lo + 1] = rp[lo:hi + 1] - rp[lo]
    S = sell_from_csr(csr_from_arrays(rows, ci[rp[lo]:rp[hi]], v[rp[lo]:rp[hi]],
                                      n_cols=r * ranks), max_padding=64.0).to("cuda")
    rng = np.random.default_rng(rank)
    x = torch.tensor(rng.standard_normal(r * ranks), device="cuda")
    b = torch.tensor(rng.standard_normal(r), device="cuda")
    before = sl.sell_residual_cuda.forms["f64_rank"]
    got = sl.sell_residual_cuda(S.vals, S.cols, S.slice_ptr, b, x, dt, x_off=rank * r)
    want = sl.sell_residual_plain(S.vals, S.cols, S.slice_ptr, b, x, dt, x_off=rank * r)
    assert sl.sell_residual_cuda.forms["f64_rank"] == before + 1
    _close(got[0], want[0], torch.float64)
    # the sums of squares: fp32 sums round apart by 1e-5, fp64 ones only by
    # their order (chip_smoke's check_residual holds fp64 to 1e-12)
    tol = 1e-5 if dt == torch.float32 else 1e-12
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g - w)) <= tol * float(w)
    with pytest.raises(ValueError):
        sl.sell_residual_cuda(S.vals, S.cols, S.slice_ptr, b, x[:r * ranks - 1], dt,
                              x_off=(ranks - 1) * r + 1)


@pytest.mark.parametrize("label", ["bilu_jacobi", "sell"])
def test_distributed_bilu_and_sell_solves_on_card_match_cpu(label):
    # two gloo ranks sharing the card: the block-Jacobi ILU's DIA factor
    # sweeps on K1 beside K12 for the operator; the per-rank SELL route's
    # block on K5, its fp64 outer residual on K5's rank form, and no K12
    from gmres_tpu_torch.ops.cuda._build import library
    from gmres_tpu_torch.parallel import launch
    from gmres_tpu_torch.parallel.dist_gmres import run_cases

    library()  # built here, so that the ranks load it
    if label == "sell":
        A = unstructured_mesh(70_000, run=8)
        kw, extra = dict(precond="identity"), {}
        want_on, want_off = {"sell_spmv", "sell_residual"}, DIST_KERNELS | {"dia_spmv"}
    else:
        A = convection_diffusion_2d(64, beta=2.0)
        kw, extra = dict(precond="bilu_jacobi", jacobi_steps=3), {}
        want_on, want_off = DIST_KERNELS | {"dia_spmv"}, {"sell_spmv", "sell_residual"}
    b = A.to_scipy() @ gmres_tpu_torch.rand_vect(A.n_rows, 42)
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("mixed"), orth="cgsr",
        restart_length=30, tol=1e-8, max_restarts=200, **kw)
    cases = [dict(A=A, b=b, cfg=cfg, **extra)]
    card = launch.spawn(run_cases, 2, args=(cases, "cuda"))
    cpu = launch.spawn(run_cases, 2, args=(cases, "cpu"))
    for (got,), (ref,) in zip(card, cpu):
        c = got["launches"]
        assert all(c[k] > 0 for k in want_on) and all(c[k] == 0 for k in want_off), c
        assert got["converged"] and abs(got["restarts"] - ref["restarts"]) <= 1
        assert np.linalg.norm(got["x"] - ref["x"]) / np.linalg.norm(ref["x"]) <= 1e-5


@pytest.mark.parametrize("tier", ["bf16", "fp32_bf16_m"])
@pytest.mark.parametrize("nx", [7, 64])
def test_bf16_ilu_jacobi_apply_on_card_matches_plain(nx, tier):
    # n = 49 and 4,096: bf16 ILU-Jacobi(3) factors on DIA (the plain-torch
    # bf16 route on either device, no K1, no K6) applied to a bf16 vector,
    # and to an fp32 one through the cast; against the same apply on the
    # CPU, within one bf16 ulp a sweep of the result's scale
    from gmres_tpu_torch.precond.apply import typesafe_apply

    A = convection_diffusion_2d(nx, beta=2.0)
    M = pbuild.optimize_precond_format(pbuild.build_ilu_jacobi(A, torch.bfloat16, 3))
    assert M.lower.data.dtype == torch.bfloat16
    dt = torch.bfloat16 if tier == "bf16" else torch.float32
    w = torch.tensor(np.random.default_rng(nx).standard_normal(A.n_rows)).to(dt)
    reset_launch_counts()
    got = typesafe_apply(M.to("cuda"), w.to("cuda"))
    counts = launch_counts()
    assert all(v == 0 for v in counts.values()), counts
    want = typesafe_apply(M, w)
    assert got.dtype == dt and got.is_cuda
    scale = float(want.abs().max())
    assert float((got.cpu().double() - want.double()).abs().max()) <= 6 * 2.0 ** -7 * scale


# The dtype forms of the compressed-basis and bf16 tiers: (basis, vectors).
# A form's kernel and its plain version sum in the same accumulation dtype in
# another order: an output is held to the accumulation dtype's tolerance of
# its scale and, rounded to bf16, one bf16 ulp (2^-7 of the value itself)
# more; K7's bf16 w, rounded after every row, to MGS_FLIPS such ulps of the
# largest value an element takes.  The inputs are an Arnoldi step's, w =
# V^T c + e with the projection most of w, so a sweep that skips it fails.
NEW_FORMS = pytest.mark.parametrize(
    "vt,wt", [(torch.bfloat16, torch.float32), (torch.float32, torch.float64),
              (torch.bfloat16, torch.bfloat16)], ids=["bf16_f32", "f32_f64", "bf16_bf16"])
FORM_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
BF16_ULP = 2.0 ** -7
MGS_FLIPS = 2


def _acc(wt):
    return torch.float64 if wt == torch.float64 else torch.float32


def _form_close(got, want, scale, dt, of=None, ulps=1.0):
    """got within FORM_TOL of the accumulation dtype x max|scale| of want,
    plus, for a bf16 output, `ulps` bf16 ulps of `of` (want unless given)
    elementwise."""
    assert got.dtype == want.dtype == dt
    bound = FORM_TOL[_acc(dt)] * float(scale.double().abs().max())
    if dt == torch.bfloat16:
        bound = bound + ulps * BF16_ULP * (want if of is None else of).double().abs()
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), (float(err.max()), dt)


def _form_basis(vt, wt, n, m1=31, seed=0):
    rng = np.random.default_rng(seed + n)
    V = rng.standard_normal((m1, n)) / np.sqrt(n)
    c = rng.standard_normal(m1)
    w = V.T @ c + 0.5 * np.sqrt(m1 / n) * rng.standard_normal(n)
    return (torch.tensor(V, dtype=vt, device="cuda"), torch.tensor(w, dtype=wt, device="cuda"),
            torch.tensor(c, dtype=wt, device="cuda"))


@NEW_FORMS
@pytest.mark.parametrize("n", [70_008, 70_001], ids=["aligned", "ragged"])
def test_basis_sweep_forms(vt, wt, n):
    # K2, K3 plain, K3 GRAM, K3 SUMSQ, K2x2 (no bf16 vectors) and K7 of each
    # form against their plain versions, at n a multiple of 8 (every row 16-
    # byte aligned) and not; outputs in the vectors' dtype (K2x2 and K3
    # SUMSQ's sum of squares in the accumulation dtype), zero past rows
    acc = _acc(wt)
    V, w, u = _form_basis(vt, wt, n)
    Va, wa, ua = V.to(acc).abs(), w.to(acc).abs(), u.to(acc).abs()
    for rows in (1, 16, 31):
        reset_launch_counts()
        got = ok.gram_cuda(V, w, rows)
        _form_close(got, ok.gram_plain(V, w, rows), ok.gram_plain(Va, wa, rows), wt)
        assert not got[rows:].any()
        sw = wa + torch.mv(Va[:rows].t(), ua[:rows])
        _form_close(ok.update_cuda(V, w, u, rows), ok.update_plain(V, w, u, rows), sw, wt)
        w1, u2 = ok.update_gram_cuda(V, w, u, rows)
        pw, pu = ok.update_gram_plain(V, w, u, rows)
        _form_close(w1, pw, sw, wt)
        _form_close(u2, pu, ok.gram_plain(Va, sw, rows), wt)
        assert not u2[rows:].any()
        w2, ss = ok.update_sumsq_cuda(V, w, u, rows)
        pw2, pss = ok.update_sumsq_plain(V, w, u, rows)
        assert torch.equal(w2, w1)  # both keep the one-row-at-a-time bits
        _form_close(w2, pw2, sw, wt)
        _form_close(ss, pss, torch.dot(sw, sw), acc)
        if wt != torch.bfloat16:
            vk = V[rows - 1].to(acc)
            for g, p_ in zip(ok.gram2_cuda(V, w, vk, rows).unbind(1),
                             ok.gram2_plain(V, w, vk, rows).unbind(1)):
                _form_close(g, p_, ok.gram_plain(Va, wa + vk.abs(), rows), acc)
        h, wm, hn = mk.mgs_cuda(V, w, rows)
        ph, pwm, phn = mk.mgs_plain(V, w, rows)
        sm = wa + torch.mv(Va[:rows].t(), ph[:rows].to(acc).abs())
        _form_close(h, ph, ok.gram_plain(Va, sm, rows), wt)
        _form_close(wm, pwm, sm, wt, of=sm, ulps=MGS_FLIPS)
        _form_close(hn, phn, torch.linalg.vector_norm(sm), wt)
        counts, sfx = form_launch_counts(), SWEEP_FORMS[(vt, wt)]
        for name in ("basis_gram", "basis_update", "basis_update_gram", "basis_update_sumsq",
                     "basis_mgs"):
            assert counts[name] == {sfx: 1}, (name, counts)


@pytest.mark.parametrize("n", [70_008, 70_001], ids=["aligned", "ragged"])
@pytest.mark.parametrize("vt,yt,xt", [(torch.bfloat16, torch.float32, torch.float64),
                                      (torch.bfloat16, torch.float32, torch.float32),
                                      (torch.float32, torch.float64, torch.float64),
                                      (torch.bfloat16, torch.bfloat16, torch.float64),
                                      (torch.bfloat16, torch.bfloat16, torch.float32)])
def test_basis_axpy_forms(vt, yt, xt, n):
    # K4: the increment summed in the accumulation dtype of (y, V) (fp64
    # for an fp64 y) and, for a bf16 y, rounded to bf16 before the add
    V, _, _ = _form_basis(vt, yt, n)
    y = torch.tensor(np.random.default_rng(n).standard_normal(30), dtype=yt, device="cuda")
    x = torch.tensor(np.random.default_rng(1).random(n), dtype=xt, device="cuda")
    got = ou.basis_axpy_cuda(x.clone(), V, y)
    want = ou.basis_axpy_plain(x.clone(), V, y)
    inc = torch.promote_types(yt, vt)
    scale = x.abs().double() + torch.mv(V[:30].double().abs().t(), y.double().abs())
    bound = (FORM_TOL[_acc(inc)] if inc != torch.float32 or xt != torch.float32 else 2e-5) \
        * float(scale.max())
    if inc == torch.bfloat16:
        # the increment rounded to bf16: one ulp of it more
        bound = bound + BF16_ULP * ou.basis_axpy_plain(torch.zeros_like(x), V, y).double().abs()
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float(err.max())


@NEW_FORMS
@pytest.mark.parametrize("n", [70_008, 2 ** 20 + 3])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "unaligned_base"])
def test_gram_and_update_gram_forms_bits_independent_of_grid(vt, wt, n, shift):
    # K2's and K3 GRAM's forms: one launch each, and the same bits on every
    # grid, also where V and w start one value past a 16-byte boundary
    rng = np.random.default_rng(n + shift)
    m1 = 31
    Vb = torch.tensor(rng.standard_normal(m1 * n + shift) / np.sqrt(n), dtype=vt, device="cuda")
    wb = torch.tensor(rng.standard_normal(n + shift), dtype=wt, device="cuda")
    V, w = Vb[shift:].view(m1, n), wb[shift:]
    u = torch.tensor(rng.standard_normal(m1), dtype=wt, device="cuda")
    for rows in (7, 31):
        reset_launch_counts()
        g = ok.gram_cuda(V, w, rows)
        w1, u2 = ok.update_gram_cuda(V, w, u, rows)
        assert launch_counts()["basis_gram"] == launch_counts()["basis_update_gram"] == 1
        for per_sm in (1, 2, 3, 4, None):
            assert torch.equal(ok.gram_cuda(V, w, rows, blocks_per_sm=per_sm), g)
            if per_sm != 4:
                a, b = ok.update_gram_cuda(V, w, u, rows, blocks_per_sm=per_sm)
                assert torch.equal(a, w1) and torch.equal(b, u2)


@pytest.mark.parametrize("form", ["bf16_f32", "f32_f64", "bf16_bf16"])
@pytest.mark.parametrize("kernel", ["gram", "update_gram"])
def test_gram_and_update_gram_forms_are_one_device_kernel(kernel, form):
    names = _device_kernels(f"{kernel}:{form}")
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("orth,low", [("cgsr", None), ("cgs", None), ("mgs", False),
                                      ("mgs", True), ("cgsr3", None)])
@pytest.mark.parametrize("mode,basis", [("mixed", "bfloat16"), ("baseline", "float32"),
                                        ("single", "bfloat16")])
def test_compressed_basis_solve_on_card_matches_cpu(mode, basis, orth, low):
    # the solve launches its orthogonalization's forms only, and converges
    # as the same solve on the CPU does: restarts within one, x within 1e4
    # x tol of the CPU's (both stop at a backward error of tol; the
    # operator's condition number is ~1e3)
    A = convection_diffusion_2d(32, beta=2.0)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    kw = dict(orth_steps=3) if orth == "cgsr3" else {}
    cfg = gmres_tpu_torch.GmresConfig(
        precision=dataclasses.replace(gmres_tpu_torch.PrecisionSpec.from_mode(mode),
                                      basis=basis),
        orth=orth[:4], low_sync_mgs=low, precond="identity", restart_length=30,
        tol=1e-8 if mode != "single" else 1e-5, max_restarts=80, **kw)
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg)
    forms = form_launch_counts()
    inner = "f32" if mode != "baseline" else "f64"
    want = f"{'bf16' if basis == 'bfloat16' else 'f32'}_{inner}"
    for name, fc in forms.items():
        if name in ("dia_spmv", "sell_spmv"):  # K1 and K5 in the inner dtype
            assert set(fc) <= {inner}, (name, fc)
            continue
        assert set(fc) <= {want} | ({"bf16_f32_f32"} if mode == "single" else
                                    {f"{want}_f64"}), (name, fc)
    assert forms["basis_axpy"] == {f"{want}_{'f32' if mode == 'single' else 'f64'}":
                                   res.restarts}, forms
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.x.is_cuda and res.converged and ref.converged
    assert abs(res.restarts - ref.restarts) <= 1
    xr = ref.x.numpy()
    assert np.linalg.norm(res.x.cpu().numpy() - xr) / np.linalg.norm(xr) <= 1e4 * cfg.tol


@pytest.mark.parametrize("fmt", ["dia", "csr"])
@pytest.mark.parametrize("orth,low", [("cgsr", None), ("mgs", False), ("mgs", True)])
def test_bf16_solve_on_card_converges(orth, low, fmt):
    # the bf16 inner tier (bf16 SpMV in plain torch ops on DIA, the CSR
    # route's index_add_ otherwise) reaches tol 1e-6 on the card as on the
    # CPU; its sweeps are the (bf16, bf16) forms, ICWY's the (bf16, f32)
    A = convection_diffusion_2d(12, beta=2.0)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec("float64", "bfloat16", "bfloat16"), orth=orth,
        low_sync_mgs=low, precond="identity", restart_length=20, tol=1e-6, max_restarts=500,
        auto_format=fmt == "dia")
    reset_launch_counts()
    res = gmres_tpu_torch.solve(A, b, cfg)
    counts, forms = launch_counts(), form_launch_counts()
    assert counts["dia_spmv"] == 0 and counts["sell_spmv"] == 0, counts
    assert forms["basis_axpy"] == {"bf16_bf16_f64": res.restarts}, forms
    sweeps = ("basis_gram2", "basis_update_sumsq") if low else (
        ("basis_mgs",) if orth == "mgs" else ("basis_gram", "basis_update_gram",
                                              "basis_update_sumsq"))
    want = "bf16_f32" if low else "bf16_bf16"
    assert all(set(forms[k]) == {want} for k in sweeps), forms
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.converged and ref.converged and not res.escalated
    # the stopping test reads the norm of the residual rounded to bf16, so
    # the fp64 backward error is held to twice the tolerance
    x = res.x.cpu().numpy()
    assert np.linalg.norm(A.to_scipy() @ x - b) <= 2e-6 * (
        np.linalg.norm(b) + np.linalg.norm(A.vals.numpy()) * np.linalg.norm(x))


@pytest.mark.parametrize("fmt", ["dia", "sell"])
def test_condest_on_card(fmt):
    # a banded matrix runs condest on K1's fp64 plain mode (A and A^T), an
    # unstructured one on K5's; sigma_max as on the CPU, and the stop test
    # (quantities compared at 8 eps, where the kernels' FMAs round otherwise)
    # fires within one step of the CPU's
    from gmres_tpu_torch.solver.condest import condest

    A = convection_diffusion_2d(32, beta=2.0) if fmt == "dia" else unstructured_mesh(4096, run=8)
    quiet = lambda *a: None  # noqa: E731
    reset_launch_counts()
    cond, smax, smin, t = condest(A, max_iters=3000, verbose=quiet)
    counts, forms = launch_counts(), form_launch_counts()
    mine, other = ("dia_spmv", "sell_spmv") if fmt == "dia" else ("sell_spmv", "dia_spmv")
    assert counts[mine] > 0 and counts[other] == 0, counts
    assert forms[mine] == {"f64": counts[mine]}, forms
    ccond, csmax, csmin, ct = condest(A, max_iters=3000, verbose=quiet, device="cpu")
    assert abs(smax - csmax) <= 1e-9 * csmax and abs(t - ct) <= 1
    assert abs(cond - ccond) <= 1e-3 * ccond


def test_solve_cli_on_card_matches_cpu():
    import contextlib
    import io

    from gmres_tpu_torch.cli import solve as cli

    out = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["--device", dev, "--synth", "convdiff:32", "--mode", "baseline",
                             "--orth", "cgsr", "--prec", "identity", "--tol", "1e-8",
                             "--json"]) == 0
        out[dev] = json.loads(buf.getvalue().splitlines()[-1])
    assert out["cuda"]["converged"]
    assert (out["cuda"]["i"], out["cuda"]["total_iters"]) == (out["cpu"]["i"],
                                                              out["cpu"]["total_iters"])


@DTYPES
@pytest.mark.parametrize("s", [1, 3, 7, 8])
@pytest.mark.parametrize("nx", [7, 45, 1024])
def test_dia_lanes_bit_equal_to_k1(dt, s, nx):
    # K1's lane form (s = 3 and 7 run one launch of 4 and 8 lanes with a
    # lane fewer, s = 8 a full one): lane j is K1 on lane j bit for bit, in
    # plain mode on a strided view of the lanes (a basis row of every lane,
    # V[:, k, :]) and
    # in residual mode with each lane's two sums; the lane plain versions are
    # K1's plain versions lane by lane, bit for bit; kernel against plain
    # within TOL (FMA against a multiply then an add)
    dia = from_csr(convection_diffusion_2d(nx, beta=2.0))
    n = dia.n_rows
    rng = np.random.default_rng(nx + s)
    data = dia.data.to("cuda", dt)
    V = torch.tensor(rng.standard_normal((s, 3, n)), dtype=dt, device="cuda")
    X = V[:, 1]
    reset_launch_counts()
    Y = sk.dia_spmv_lanes_cuda(data, dia.offsets, X)
    forms = form_launch_counts()["dia_spmv"]
    assert sum(forms.values()) == len(sk.lane_chunks(s)) and all("lanes" in f for f in forms)
    plain = sk.dia_spmv_lanes_plain(data, dia.offsets, X)
    for j in range(s):
        assert torch.equal(Y[j], sk.dia_spmv_cuda(data, dia.offsets, X[j].contiguous()))
        assert torch.equal(plain[j], sk.dia_spmv_plain(data, dia.offsets, X[j]))
        _close(Y[j], plain[j], dt)
    d64 = dia.data.to("cuda")
    B = torch.tensor(rng.standard_normal((s, n)), device="cuda")
    X64 = torch.tensor(rng.random((s, n)), device="cuda")
    R, r_ss, x_ss = sk.dia_residual_lanes_cuda(d64, dia.offsets, B, X64, dt)
    Rp, rp_ss, xp_ss = sk.dia_residual_lanes_plain(d64, dia.offsets, B, X64, dt)
    for j in range(s):
        r1, rs1, xs1 = sk.dia_residual_cuda(d64, dia.offsets, B[j], X64[j], dt)
        assert torch.equal(R[j], r1) and torch.equal(r_ss[j], rs1) and torch.equal(x_ss[j], xs1)
        _close(R[j], Rp[j], torch.float64)
        assert abs(float(r_ss[j] - rp_ss[j])) <= 1e-5 * float(rp_ss[j])
        assert abs(float(x_ss[j] - xp_ss[j])) <= 1e-12 * float(xp_ss[j])


def test_dia_lanes_wrappers_refuse_what_the_kernel_does_not_take():
    dia = from_csr(convection_diffusion_2d(7))
    data = dia.data.to("cuda")
    X = torch.zeros((2, dia.n_rows), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        sk.dia_spmv_lanes_cuda(data, dia.offsets, X.float())
    with pytest.raises(ValueError, match="contiguous"):
        sk.dia_spmv_lanes_cuda(data, dia.offsets, torch.zeros((dia.n_rows, 2), device="cuda",
                                                               dtype=torch.float64).t())
    with pytest.raises(ValueError):
        sk.dia_spmv_lanes_cuda(data, dia.offsets, X.cpu())
    with pytest.raises(ValueError):
        sk.dia_residual_lanes_cuda(data, dia.offsets, X[:1], X, torch.float32)


def _round_to(q: Fraction, dt) -> float:
    """The exact value q rounded once to dt, to nearest, ties to even (q in
    dt's normal range or 0; Python's int division rounds so to fp64)."""
    if dt == torch.float64 or q == 0:
        return float(q)
    a = abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    while a >= Fraction(2) ** e:
        e += 1
    while a < Fraction(2) ** (e - 1):
        e -= 1
    scaled = a * Fraction(2) ** (24 - e)
    m, rem = divmod(scaled.numerator, scaled.denominator)
    if 2 * rem > scaled.denominator or (2 * rem == scaled.denominator and m % 2):
        m += 1
    return math.copysign(math.ldexp(m, e - 24), q)


def _fma_chain(data, offsets, X, n_cols, dt):
    """y of one fused multiply-add chain a row and lane, bands in ascending
    order from 0, each step rounded once to dt (the bands past [0, n_cols)
    add nothing): numpy (lanes, n) float64 holding dt's values."""
    D, n = data.shape
    dv = [[Fraction(float(v)) for v in row] for row in data]
    out = np.zeros((X.shape[0], n))
    for l in range(X.shape[0]):
        xv = [Fraction(float(v)) for v in X[l]]
        for i in range(n):
            acc = Fraction(0)
            for d, off in enumerate(offsets):
                if 0 <= i + off < n_cols:
                    acc = Fraction(_round_to(dv[d][i] * xv[i + off] + acc, dt))
            out[l, i] = float(acc)
    return out


def _minus(B, Y, dt):
    """b - y rounded once to dt, elementwise."""
    return np.vectorize(lambda b, y: _round_to(Fraction(float(b)) - Fraction(float(y)), dt))(
        B, Y)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


# (n, n_cols, offsets, lanes, layout): the general form of K1 -- odd n, n
# not a multiple of the 16-byte chunk, lanes of a strided view whose lane
# stride is off 16-byte alignment, x at an offset pointer, a rectangular
# operator, ILU factor bands (offsets <= 0), a random band set; and the
# aligned form
K1_BIT_CASES = [
    (2025, 2025, (-45, -1, 0, 1, 45), 3, "strided"),      # convdiff(45), x_ld = 3n
    (4096, 4096, (-700, -3, 0, 2, 5, 9, 1100), 8, "shifted"),  # x at +1 value
    (1025, 1025, (-32, -1, 0), 1, "shifted"),             # an ILU L factor
    (1000, 1300, (-20, 0, 7, 900), 2, "strided"),         # n_cols != n (plain mode)
    (4096, 4096, (-64, -1, 0, 1, 64), 4, "strided"),      # the aligned form
]


def _k1_lanes(case, dt, seed):
    """The case's bands (dt, D x n, random also where a band reads past x),
    X (s, n_cols) laid out as the case says and B (s, n) on the card."""
    n, n_cols, offsets, s, layout = case
    rng = np.random.default_rng(seed)
    data = torch.tensor(rng.standard_normal((len(offsets), n)), dtype=dt, device="cuda")
    if layout == "strided":
        X = torch.tensor(rng.standard_normal((s, 3, n_cols)), dtype=dt, device="cuda")[:, 1]
    else:
        buf = torch.tensor(rng.standard_normal(s * n_cols + 1), dtype=dt, device="cuda")
        X = buf[1:].view(s, n_cols)
    B = torch.tensor(rng.standard_normal((s, n)), dtype=dt, device="cuda")
    return data, offsets, X, B


@DTYPES
@pytest.mark.parametrize("case", K1_BIT_CASES,
                         ids=[f"n{c[0]}-c{c[1]}-D{len(c[2])}-s{c[3]}-{c[4]}"
                              for c in K1_BIT_CASES])
def test_dia_bits_are_one_fma_chain_on_every_grid(dt, case):
    # y (K1 and its lane form) and r (both residual forms) are the bits of
    # one fused multiply-add chain a row, bands ascending from 0, on every
    # grid and in the general form; the residual sums are the same bits on
    # every grid and within the plain version's tolerance
    n, n_cols, offsets, s, _ = case
    data, offsets, X, B = _k1_lanes(case, dt, n + s)
    y_np = _fma_chain(data.cpu().numpy(), offsets, X.cpu().numpy(), n_cols, dt)
    want_y = torch.tensor(y_np, dtype=dt, device="cuda")
    square = n == n_cols
    if square:
        want_r = torch.tensor(_minus(B.cpu().numpy(), y_np, dt), dtype=dt, device="cuda")
    plan = sk.dia_plan(offsets, n, n_cols, data.element_size())
    sums = []
    for grid in (None, 1, 3, plan.n_blocks + 5):
        Y = sk.dia_spmv_lanes_cuda(data, offsets, X, grid=grid)
        assert torch.equal(_bits(Y), _bits(want_y)), grid
        if s == 1:
            y = sk.dia_spmv_cuda(data, offsets, X[0], grid=grid)
            assert torch.equal(_bits(y), _bits(want_y[0]))
        if not square:
            continue
        R, r_ss, x_ss = sk.dia_residual_lanes_cuda(data, offsets, B, X, torch.float32,
                                                   grid=grid)
        assert torch.equal(_bits(R), _bits(want_r)), grid
        sums.append(torch.stack([r_ss, x_ss]))
        if s == 1:
            r, rs, xs = sk.dia_residual_cuda(data, offsets, B[0], X[0], torch.float32, grid=grid)
            assert torch.equal(_bits(r), _bits(want_r[0]))
            assert torch.equal(torch.stack([rs, xs]), sums[-1][:, 0])
    if square:
        assert all(torch.equal(t, sums[0]) for t in sums)
        _, rp, xp = sk.dia_residual_lanes_plain(data, offsets, B, X, torch.float32)
        # the plain version sums r' (fp32) in fp32
        assert float(((sums[0][0] - rp).abs() / rp).max()) <= 1e-5
        assert float(((sums[0][1] - xp).abs() / xp).max()) <= 1e-5


@pytest.mark.parametrize("lanes", [None, 1, 2, 3, 4, 8])
def test_dia_residual_is_one_device_kernel(lanes):
    # K1's residual mode, single and its lane form at s <= 8, is one device
    # kernel a call: the launch adds its blocks' sums, no torch op follows
    name = "dia_residual" if lanes is None else f"dia_residual_lanes:{lanes}"
    names = _device_kernels(name)
    assert len(names) == 1 and "dia_spmv_kernel" in names[0], names


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_solve_batched_on_card_matches_solve(mode):
    # each lane's counts are those of solve() on the card of its b, and the
    # batched solve launches K1's lane form in both modes and the sweeps,
    # never K1's single-lane forms, K5-K12, K7, K2x2 or K3's plain mode
    A = convection_diffusion_2d(32, beta=2.0)
    B = np.stack([A.to_scipy() @ gmres_tpu_torch.rand_vect(A.n_rows, 40 + j) for j in range(5)])
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth="cgsr",
        precond="jacobi", restart_length=30, tol=1e-8, max_restarts=80)
    reset_launch_counts()
    res = gmres_tpu_torch.solve_batched(A, B, cfg)
    counts, forms = launch_counts(), form_launch_counts()
    # five lanes are one launch of the 8-lane form; fewer as lanes finish
    k1 = "f64" if mode == "baseline" else "f32"
    assert f"{k1}_lanes8" in forms["dia_spmv"] and set(forms["dia_spmv"]) <= {
        f"{k1}_lanes{w}" for w in (8, 4, 2, 1)}, forms
    assert "f64_lanes8" in forms["dia_residual"] and set(forms["dia_residual"]) <= {
        f"f64_lanes{w}" for w in (8, 4, 2, 1)}, forms
    used = {"dia_spmv", "dia_residual", "basis_gram", "basis_update_gram",
            "basis_update_sumsq", "basis_axpy"}
    assert all(counts[k] > 0 for k in used) and all(counts[k] == 0 for k in counts
                                                    if k not in used), counts
    for b, r in zip(B, res):
        one = gmres_tpu_torch.solve(A, b, cfg)
        assert r.x.is_cuda and r.converged
        assert (r.restarts, r.total_iters) == (one.restarts, one.total_iters)
        tol = 1e-9 if mode == "baseline" else 1e-5
        xo = one.x.cpu().numpy()
        assert np.linalg.norm(r.x.cpu().numpy() - xo) / np.linalg.norm(xo) <= tol
