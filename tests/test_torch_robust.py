"""The port's NaN fp64 fallback and solver checkpoints on the CPU, after
``tests/test_aux.py:65-129`` and ``tests/test_round2_fixes.py:22-89``, and
the checkpoint file read across the two packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu_torch
from gmres_tpu.solver.policies import initial_policy_state as jax_initial_policy_state
from gmres_tpu.utils import checkpoint as jax_ckpt
from gmres_tpu_torch import GmresConfig, PrecisionSpec, solve
from gmres_tpu_torch.io.synth import convection_diffusion_2d, poisson_2d
from gmres_tpu_torch.solver.policies import PolicyState, initial_policy_state
from gmres_tpu_torch.sparse import csr_from_coo
from gmres_tpu_torch.utils.checkpoint import CheckpointSpec, load, save


def _overflow_matrix(n=32, big=3e38):
    """A diagonal matrix whose fp32 copy overflows the inner loop at once
    (||A||_F and the Arnoldi norms are inf in fp32)."""
    rows = np.arange(n)
    return csr_from_coo(rows, rows, np.full(n, big), n_rows=n), big


@pytest.mark.parametrize("precond", ["identity", "jacobi"])
def test_nan_fallback(precond):
    A, big = _overflow_matrix()
    b = np.ones(A.n_rows)
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"), precond=precond,
                      restart_length=5, tol=1e-10, max_restarts=50, nan_fallback=True,
                      auto_format=False)
    res = solve(A, b, cfg, device="cpu")
    assert res.fellback_to_fp64 and res.converged and not res.diverged
    # x to what the criterion promises: for A = big I and b = 1,
    # ||r|| <= tol (||b|| + ||A||_F ||x||) bounds the relative error of x by
    # tol (1 + sqrt(n)) ~ 6.7e-10.  (The Krylov space is invariant after one
    # step, so the later columns of the first cycle repeat v_0 to rounding and
    # the cycle's least-squares problem is singular to rounding: the JAX
    # package happens to finish in one restart with x to 4e-16, the port in
    # 13, for the rounding of their sums.)
    np.testing.assert_allclose(res.x.numpy(), 1.0 / big, rtol=cfg.tol * (1 + np.sqrt(32)))
    assert res.solve_seconds > 0 and res.prec_seconds >= 0
    # without the fallback the divergence is reported as data (the
    # reference's behavior)
    res2 = solve(A, b, cfg.with_(nan_fallback=False), device="cpu")
    assert res2.diverged and res2.aborted and not res2.converged
    assert not res2.fellback_to_fp64


def test_nan_fallback_with_ilu_jacobi():
    # fp32 overflow of ||b|| on a well-scaled operator: the fp64 rescue
    # rebuilds the ILU-Jacobi factors in fp64 from the CSR matrix
    A = poisson_2d(8)
    x_true = 1e20 * np.ones(A.n_rows)
    b = A.to_scipy() @ x_true
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"), precond="ilu_jacobi",
                      jacobi_steps=2, restart_length=10, tol=1e-12, max_restarts=200,
                      nan_fallback=True, auto_format=False)
    res = solve(A, b, cfg, device="cpu")
    assert res.fellback_to_fp64 and res.converged
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6)


def test_nan_fallback_never_reuses_a_low_precision_ilu():
    # a staged operator carries no CSR structure: the fp64 ILU cannot be
    # rebuilt, and the fallback raises instead of reusing the fp32 M
    from gmres_tpu_torch.precond.build import build_preconditioner

    A = poisson_2d(8)
    b = A.to_scipy() @ (1e20 * np.ones(A.n_rows))
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"), precond="ilu_jacobi",
                      jacobi_steps=2, restart_length=10, tol=1e-12, max_restarts=200,
                      nan_fallback=True)
    staged = gmres_tpu_torch.stage(A, cfg, device="cpu")
    M = build_preconditioner(A, cfg)
    assert solve(staged, b, cfg.with_(nan_fallback=False), M=M, device="cpu").diverged
    with pytest.raises(TypeError, match="CSR"):
        solve(staged, b, cfg, M=M, device="cpu")


def test_baseline_never_falls_back():
    A, _ = _overflow_matrix(big=np.inf)
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("baseline"), precond="identity",
                      restart_length=5, tol=1e-10, max_restarts=5, nan_fallback=True,
                      auto_format=False)
    res = solve(A, np.ones(A.n_rows), cfg, device="cpu")
    assert res.diverged and not res.fellback_to_fp64


def test_checkpoint_save_load(tmp_path):
    p = str(tmp_path / "state.ckpt")
    x = np.arange(8.0)
    ps = PolicyState(is_first=False, second_restart_length=7, restart_tol=0.25)
    save(p, torch.from_numpy(x), 3, 90, ps)
    x2, i, iters, ps2 = load(p)
    np.testing.assert_array_equal(x2, x)
    assert (i, iters, ps2) == (3, 90, ps)
    assert load(str(tmp_path / "missing.ckpt")) is None
    assert [f.name for f in tmp_path.iterdir()] == ["state.ckpt"]  # no temporary left


def test_checkpoint_files_cross_packages(tmp_path):
    # the JAX package's load reads a port file, and the port's a JAX one
    p = str(tmp_path / "port.ckpt")
    x = np.linspace(0.0, 1.0, 11)
    save(p, torch.from_numpy(x), 4, 120, PolicyState(False, 9, 1e-3))
    jx, ji, jiters, jps = jax_ckpt.load(p)
    np.testing.assert_array_equal(jx, x)
    assert (ji, jiters) == (4, 120)
    assert (bool(jps.is_first), int(jps.second_restart_length), float(jps.restart_tol)) == \
        (False, 9, 1e-3)
    assert jps.second_restart_length.dtype == jnp.int32 and jps.restart_tol.dtype == jnp.float64
    q = str(tmp_path / "jax.ckpt")
    jax_ckpt.save(q, jnp.asarray(x), 2, 60, jax_initial_policy_state())
    px, pi, piters, pps = load(q)
    np.testing.assert_array_equal(px, x)
    assert (pi, piters, pps) == (2, 60, initial_policy_state())


@pytest.mark.parametrize("mode", ["baseline", "df64"])
def test_checkpoint_resume_solve(tmp_path, mode):
    A = poisson_2d(14)
    b = A.to_scipy() @ gmres_tpu_torch.rand_vect(A.n_rows, 42)
    cfg = GmresConfig(precision=PrecisionSpec.from_mode(mode), precond="identity",
                      restart_length=10, tol=1e-8, max_restarts=1000)
    full = solve(A, b, cfg, device="cpu")
    assert full.converged and full.restarts >= 3
    # a budget that aborts partway, checkpointing every restart
    ck = CheckpointSpec(path=str(tmp_path / "s.ckpt"), every=1)
    part = solve(A, b, cfg.with_(max_restarts=2), checkpoint=ck, device="cpu")
    assert part.aborted and load(ck.path)[1:3] == (2, part.total_iters)
    # the resume picks the file up and finishes where the uninterrupted run did
    res = solve(A, b, cfg, checkpoint=ck, device="cpu")
    assert res.converged
    assert (res.restarts, res.total_iters) == (full.restarts, full.total_iters)
    np.testing.assert_allclose(res.x.numpy(), full.x.numpy(), rtol=1e-10)


def test_checkpoint_keeps_the_repeat_policy_state(tmp_path):
    # REPEAT: the file written after the first cycles carries the first
    # cycle's length, so the resumed cycles keep it
    A = convection_diffusion_2d(16, beta=1.0)
    b = A.to_scipy() @ gmres_tpu_torch.rand_vect(A.n_rows, 42)
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"), orth="cgsr",
                      precond="identity", restart_length=30, tol=1e-10, max_restarts=40,
                      policy="repeat", restart_improvement=1e-1)
    full = solve(A, b, cfg, device="cpu", record_history=True)
    ks = [h["k"] for h in full.history if h["k"]]
    assert len(ks) > 4 and ks[0] < cfg.m and set(ks) == {ks[0]}
    ck = CheckpointSpec(path=str(tmp_path / "r.ckpt"), every=3)
    solve(A, b, cfg.with_(max_restarts=4), checkpoint=ck, device="cpu")
    _, i, iters, ps = load(ck.path)
    assert (i, iters) == (3, 3 * ks[0])
    assert ps.is_first is False and ps.second_restart_length == ks[0]
    res = solve(A, b, cfg, checkpoint=ck, device="cpu", record_history=True)
    assert [h["k"] for h in res.history] == [h["k"] for h in full.history][3:]
    assert (res.converged, res.restarts, res.total_iters) == (full.converged, full.restarts,
                                                              full.total_iters)
    np.testing.assert_allclose(res.x.numpy(), full.x.numpy(), rtol=1e-12)


def test_stalled_checkpoint_files_cross_packages(tmp_path):
    # the key that marks a stalled bf16 phase leaves the file readable by
    # the JAX package, and a file without it reads as not stalled
    from gmres_tpu_torch.utils.checkpoint import load_phase, save_stalled

    ck = CheckpointSpec(path=str(tmp_path / "s.ckpt"))
    open(ck.continuation().path, "w").close()  # an earlier continuation's file
    x = np.linspace(-1.0, 1.0, 9)
    save_stalled(ck, torch.from_numpy(x), 16, 960, PolicyState(True, 0, 0.0))
    assert not os.path.exists(ck.continuation().path)
    jx, ji, jiters, _ = jax_ckpt.load(ck.path)
    np.testing.assert_array_equal(jx, x)
    assert (ji, jiters) == (16, 960)
    assert load_phase(ck.path)[1:3] + load_phase(ck.path)[4:] == (16, 960, True)
    q = str(tmp_path / "jax.ckpt")
    jax_ckpt.save(q, jnp.asarray(x), 2, 60, jax_initial_policy_state())
    assert load_phase(q)[4] is False
