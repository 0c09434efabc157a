"""The slice as a whole: ``gmres_tpu.solve`` and ``gmres_tpu_torch.solve``
(on the CPU, through the plain versions of the kernels) on the same operator,
carried across with ``gmres_tpu_torch.convert``.

On ``convection_diffusion_2d(64, beta=2.0)`` (the benchmark's problem at
n = 4096) both must take 10 restarts / 300 iterations; on
``unstructured_mesh(4096, run=8)``, which the port stages as SELL and the
JAX package on the CPU runs as CSR, 1 restart / 30 iterations.  Per-cycle relative
residuals agree to 1e-8 in baseline (fp64 throughout, sums in another order)
and 1e-4 in mixed (fp32 inner loop: the orderings differ by fp32 rounding,
which compounds over a cycle); solutions to 1e-9 and 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.io.synth import poisson_2d as jax_poisson
from gmres_tpu.io.synth import random_sparse as jax_random_sparse
from gmres_tpu.io.synth import unstructured_mesh as jax_mesh
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.precond.build import build_preconditioner as jax_build_preconditioner
from gmres_tpu_torch.convert import csr_from_numpy, dia_from_numpy, jacobi_from_numpy
from gmres_tpu_torch.ops import sell as port_sell

from oracle_gmres import oracle_solve

TOL = {"baseline": dict(rel=1e-8, x=1e-9), "mixed": dict(rel=1e-4, x=1e-5)}
# One cycle takes the mesh and the RCM problems to a relative residual of
# ~1e-17 (baseline) or ~3e-9 (mixed), at the inner dtype's rounding floor:
# there the final check's values are held to below the unit roundoff
# (1.1e-16 fp64, 6e-8 fp32) of ||b|| + ||A||_F ||x||, not relative to
# themselves.
FLOOR = {"baseline": 1e-16, "mixed": 1e-8}


def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


def _configs(mode, **kw):
    common = dict(orth="cgsr", precond="identity", restart_length=30, tol=1e-8,
                  max_restarts=80)
    common.update(kw)
    return (gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec.from_mode(mode), **common),
            gmres_tpu_torch.GmresConfig(
                precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), **common))


def _dense(A):
    rp = np.asarray(A.row_ptr).astype(np.int64)
    rows = np.repeat(np.arange(A.n_rows), np.diff(rp))
    dense = np.zeros((A.n_rows, A.n_cols))
    np.add.at(dense, (rows, np.asarray(A.col_idx)[: A.nnz]), np.asarray(A.vals)[: A.nnz])
    return dense


def _port_dia(A):
    dia = jax_from_csr(A)
    return dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.n_rows, dia.n_cols,
                          dia.nnz)


def _port_csr(A):
    return csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                          n_cols=A.n_cols)


def _agree(res_jax, res_port, tol, floor=0.0):
    """Same history and solution; per-cycle values within tol["rel"], or
    within ``floor`` where a residual has reached the inner dtype's
    rounding floor and two summation orders differ by their rounding."""
    assert res_port.converged and res_jax.converged
    assert (res_port.restarts, res_port.total_iters) == (res_jax.restarts, res_jax.total_iters)
    hj, hp = res_jax.history, res_port.history
    assert [h["k"] for h in hp] == [h["k"] for h in hj]
    for key in ("rel_initial", "prec_rel0"):
        # prec_rel0 divides the same residual by ||b|| instead of
        # ||b|| + ||A||_F ||x||: its floor scales by the ratio
        atol = floor * hj[-1][key] / hj[-1]["rel_initial"] if floor else 0.0
        np.testing.assert_allclose([h[key] for h in hp], [h[key] for h in hj], rtol=tol["rel"],
                                   atol=atol)
    np.testing.assert_allclose([h["arnoldi_final"] for h in hp[:-1]],
                               [h["arnoldi_final"] for h in hj[:-1]], rtol=tol["rel"])
    xj, xp = np.asarray(res_jax.x), res_port.x.numpy()
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= tol["x"]


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_bench_problem_history_matches_jax(mode):
    A = jax_convdiff(64, beta=2.0)
    _, b = _problem(A)
    cj, cp = _configs(mode)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True)
    res_port = gmres_tpu_torch.solve(_port_dia(A), b, cp, record_history=True, device="cpu")
    assert (res_port.restarts, res_port.total_iters) == (10, 300)
    _agree(res_jax, res_port, TOL[mode])
    # the solver's own criterion, recomputed in fp64 outside both packages
    x = res_port.x.numpy()
    r = b - scipy.sparse.csr_matrix(
        (np.asarray(A.vals)[: A.nnz], np.asarray(A.col_idx)[: A.nnz], np.asarray(A.row_ptr)),
        shape=A.shape) @ x
    backward = np.linalg.norm(r) / (np.linalg.norm(b)
                                    + np.linalg.norm(np.asarray(A.vals)) * np.linalg.norm(x))
    assert backward <= 1e-8


def test_graft_entry_config_matches_jax():
    # __graft_entry__.py's configuration: poisson_2d(16), mixed, Jacobi,
    # restart length 20; the port takes the CSR matrix (repacked to DIA by
    # its own from_csr) and the JAX package's Jacobi preconditioner state.
    # Its last cycles start from residuals near 1e-9 of ||b||, far below
    # fp32's resolution, where the two fp32 summation orders leave 1e-3
    # relative differences: per-cycle values are held to 1e-2 there
    A = jax_poisson(16)
    _, b = _problem(A)
    cj, cp = _configs("mixed", precond="jacobi", restart_length=20)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True)
    M = jacobi_from_numpy(np.asarray(jax_build_preconditioner(A, cj).inv_diag))
    A_port = csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                            n_cols=A.n_cols)
    res_port = gmres_tpu_torch.solve(A_port, b, cp, M=M, record_history=True, device="cpu")
    _agree(res_jax, res_port, dict(rel=1e-2, x=TOL["mixed"]["x"]))


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_abort_at_max_restarts_matches_jax(mode):
    # the count-before-test quirk: max_restarts bounds cycles including the
    # converged one, so a cap below the need aborts with `restarts == cap`
    A = jax_convdiff(32, beta=2.0)
    _, b = _problem(A)
    cj, cp = _configs(mode, max_restarts=2)
    res_jax = gmres_tpu.solve(A, b, cj)
    res_port = gmres_tpu_torch.solve(_port_dia(A), b, cp, device="cpu")
    assert res_port.aborted and res_jax.aborted and not res_port.converged
    assert (res_port.restarts, res_port.total_iters) == (res_jax.restarts, res_jax.total_iters) == (2, 60)
    xj = np.asarray(res_jax.x)
    assert np.linalg.norm(res_port.x.numpy() - xj) / np.linalg.norm(xj) <= TOL[mode]["x"]


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_matches_dense_oracle(mode):
    # pinned, as tests/test_golden_oracle.py pins gmres_tpu, to the
    # independent dense transcription of the reference; fp rounding may
    # shift a restart boundary by one
    A = jax_convdiff(24, beta=1.0)
    _, b = _problem(A)
    ref = oracle_solve(_dense(A), b, tol=1e-8, rlen=40, max_restarts=400, orth="cgsr",
                       mode=mode, policy="fixed")
    assert ref.converged
    _, cp = _configs(mode, restart_length=40, max_restarts=400)
    res = gmres_tpu_torch.solve(_port_dia(A), b, cp, device="cpu")
    assert res.converged
    assert abs(res.restarts - ref.restarts) <= 1
    assert abs(res.total_iters - ref.total_iters) <= max(2, 0.05 * ref.total_iters)


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_mesh_history_matches_jax_through_sell(mode, monkeypatch):
    # the port repacks the CSR matrix to SELL inside solve(); count the
    # plain SpMV's calls to see it: 30 Arnoldi steps (the outer residual
    # takes the residual mode's own call)
    monkeypatch.setenv("GMRES_TPU_SELL_NUMPY", "1")  # never build the native packer
    A = jax_mesh(4096, run=8)
    _, b = _problem(A)
    calls = []
    plain = port_sell.sell_spmv_plain
    monkeypatch.setattr(port_sell, "sell_spmv_plain",
                        lambda *a: calls.append(a[0].dtype) or plain(*a))
    cj, cp = _configs(mode)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True)
    res_port = gmres_tpu_torch.solve(_port_csr(A), b, cp, record_history=True, device="cpu")
    assert (res_port.restarts, res_port.total_iters) == (1, 30)
    assert calls == [cp.precision.inner_dtype] * 30
    _agree(res_jax, res_port, TOL[mode], FLOOR[mode])


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_mesh_matches_dense_oracle(mode):
    A = jax_mesh(4096, run=8)
    _, b = _problem(A)
    ref = oracle_solve(_dense(A), b, tol=1e-8, rlen=30, max_restarts=80, orth="cgsr",
                       mode=mode, policy="fixed")
    _, cp = _configs(mode)
    res = gmres_tpu_torch.solve(_port_csr(A), b, cp, device="cpu")
    assert ref.converged and res.converged
    assert (res.restarts, res.total_iters) == (ref.restarts, ref.total_iters) == (1, 30)
    x = res.x.numpy()
    assert np.linalg.norm(x - ref.x) / np.linalg.norm(ref.x) <= TOL[mode]["x"]


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_rcm_reorder_matches_jax(mode, monkeypatch):
    # a scattered pattern: DIA refuses it before and after the reordering,
    # so the port solves the permuted system on SELL, the JAX package on CSR
    monkeypatch.setenv("GMRES_TPU_SELL_NUMPY", "1")
    A = jax_random_sparse(2000, row_nnz=6, seed=3)
    x_true, b = _problem(A)
    cj, cp = _configs(mode)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True, reorder="rcm")
    res_port = gmres_tpu_torch.solve(_port_csr(A), b, cp, record_history=True,
                                     device="cpu", reorder="rcm")
    _agree(res_jax, res_port, TOL[mode], FLOOR[mode])
    assert np.linalg.norm(res_port.x.numpy() - x_true) <= 1e-6 * np.linalg.norm(x_true)


def test_auto_reorder_is_rcm():
    # cfg.auto_reorder on a matrix DIA refuses takes the RCM route; b as a
    # tensor is permuted on its device
    A = _port_csr(jax_random_sparse(1000, row_nnz=5, seed=4))
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(A.n_rows))
    _, cp = _configs("mixed")
    want = gmres_tpu_torch.solve(A, b.numpy(), cp, device="cpu", reorder="rcm")
    got = gmres_tpu_torch.solve(A, b, cp.with_(auto_reorder=True), device="cpu")
    assert got.converged and got.total_iters == want.total_iters
    assert torch.equal(got.x, want.x)
    plain = gmres_tpu_torch.solve(A, b, cp, device="cpu")
    assert not torch.equal(plain.x, want.x)
    with pytest.raises(ValueError, match="reorder"):
        gmres_tpu_torch.solve(A, b, cp, device="cpu", reorder="amd")
