"""Kernels K1-K5 on the card against their plain PyTorch versions, at small
and ragged sizes (n not a multiple of the block, tile or slice; empty rows;
a long row; n_cols != n_rows), and small DIA and SELL solves on the card
against the same solves on the CPU.

These need an NVIDIA GPU with the CUDA toolkit: they carry the ``cuda``
marker and skip elsewhere.  On the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

import gmres_tpu_torch
from gmres_tpu_torch.io.synth import convection_diffusion_2d, random_sparse, unstructured_mesh
from gmres_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from gmres_tpu_torch.ops.cuda import orth_kernel as ok
from gmres_tpu_torch.ops.cuda import outer_kernel as ou
from gmres_tpu_torch.ops.cuda import sell_kernel as sl
from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.ops.sell import SELLMatrix, sell_from_csr
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


def test_wrappers_refuse_what_the_kernels_do_not_take():
    V = torch.zeros((4, 100), device="cuda")
    with pytest.raises(ValueError):
        ok.gram_cuda(V.cpu(), torch.zeros(100), 2)
    with pytest.raises(TypeError):
        ok.gram_cuda(V, torch.zeros(100, device="cuda", dtype=torch.float64), 2)
    with pytest.raises(ValueError):
        ok.gram_cuda(V, torch.zeros(200, device="cuda")[::2], 2)
    with pytest.raises(ValueError):
        ok.gram_cuda(V, torch.zeros(100, device="cuda"), 5)


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


@pytest.mark.parametrize("fmt", ["dia", "sell"])
@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_solve_on_card_matches_cpu(mode, fmt):
    # each path launches its own SpMV kernels and the shared sweeps, and
    # not the other path's SpMV kernels
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
    other = PATH_KERNELS["sell" if fmt == "dia" else "dia"]
    assert all(counts[k] > 0 for k in counts if k not in other), counts
    assert all(counts[k] == 0 for k in other), counts
    ref = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert res.x.is_cuda and res.converged
    assert (res.restarts, res.total_iters) == (ref.restarts, ref.total_iters)
    xr = ref.x.numpy()
    tol = 1e-9 if mode == "baseline" else 1e-5
    assert np.linalg.norm(res.x.cpu().numpy() - xr) / np.linalg.norm(xr) <= tol
