"""The MGS and restart-policy slice as a whole: ``gmres_tpu.solve`` and
``gmres_tpu_torch.solve(device="cpu")`` (through the plain versions of the
kernels) on the same operator, and the port pinned to the dense numpy
oracle ``tests/oracle_gmres.py``.

Held to the same per-cycle k lists, restarts and iterations, with per-cycle
relative residuals within 1e-8 (baseline) and 1e-4 (mixed), and solutions
within 1e-9 and 1e-5 (the tolerances of ``tests/test_torch_solver.py``: the
same sums in another order, compounded over a cycle in fp32), on its bench
problem ``convection_diffusion_2d(64, beta=2.0)``; or, where they differ by
more, to below the inner dtype's rounding floor of ||b|| + ||A||_F ||x||
(``FLOOR`` there).  Mixed MGS needs it: its k+1 sequential fp32 dots round
differently in XLA and torch, and the cycles' residuals of 1e-6..1e-9 then
differ by up to 3e-4 relative, 4e-10 of ||b|| + ||A||_F ||x||, against
fp32's 6e-8.

The orthloss policy is run at ``restart_improvement`` 1e-2, where the loss
recurrence runs every step and never fires (as at convdiff@1M), and at 0,
where it fires at the first step of every cycle: on these problems every
threshold in between is reached only by rounding noise, where two summation
orders legitimately part.
"""

import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.io.synth import unstructured_mesh as jax_mesh
from gmres_tpu_torch.config import LOWSYNC_MGS_DEFAULT, use_lowsync_mgs
from gmres_tpu_torch.convert import csr_from_numpy

from oracle_gmres import oracle_solve
from test_golden_oracle import _unstructured
from test_torch_solver import FLOOR, TOL, _configs, _dense, _port_dia, _problem


def _solve_both(A, mode, **kw):
    _, b = _problem(A)
    cj, cp = _configs(mode, **kw)
    res_jax = gmres_tpu.solve(A, b, cj, record_history=True)
    res_port = gmres_tpu_torch.solve(_port_dia(A), b, cp, record_history=True, device="cpu")
    return res_jax, res_port


def _agree_floor(res_jax, res_port, mode):
    """``test_torch_solver._agree`` with its floor on every per-cycle value:
    the Arnoldi proxy |s(k+1)| of a cycle is held to the floor of the next
    cycle's ||b|| + ||A||_F ||x||, which is |s(k+1)| / rel_initial there."""
    assert res_port.converged and res_jax.converged
    assert (res_port.restarts, res_port.total_iters) == (res_jax.restarts, res_jax.total_iters)
    hj, hp = res_jax.history, res_port.history
    assert [h["k"] for h in hp] == [h["k"] for h in hj]
    rtol, floor = TOL[mode]["rel"], FLOOR[mode]
    for key in ("rel_initial", "prec_rel0"):
        np.testing.assert_allclose([h[key] for h in hp], [h[key] for h in hj], rtol=rtol,
                                   atol=floor * hj[-1][key] / hj[-1]["rel_initial"])
    for a, b, nxt in zip(hp[:-1], hj[:-1], hj[1:]):
        np.testing.assert_allclose(a["arnoldi_final"], b["arnoldi_final"], rtol=rtol,
                                   atol=floor * b["arnoldi_final"] / nxt["rel_initial"])
    xj, xp = np.asarray(res_jax.x), res_port.x.numpy()
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= TOL[mode]["x"]


def _same_cycles(res_jax, res_port, mode):
    """Same outcome, per-cycle k and (for the cycles that ran) residuals."""
    assert (res_port.converged, res_port.aborted) == (res_jax.converged, res_jax.aborted)
    assert (res_port.restarts, res_port.total_iters) == (res_jax.restarts, res_jax.total_iters)
    assert [h["k"] for h in res_port.history] == [h["k"] for h in res_jax.history]
    np.testing.assert_allclose([h["rel_initial"] for h in res_port.history],
                               [h["rel_initial"] for h in res_jax.history], rtol=TOL[mode]["rel"],
                               atol=FLOOR[mode])


@pytest.mark.parametrize("lowsync", [False, True], ids=["sequential", "icwy"])
@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_mgs_history_matches_jax(mode, lowsync):
    res_jax, res_port = _solve_both(jax_convdiff(64, beta=2.0), mode, orth="mgs",
                                    low_sync_mgs=lowsync)
    assert (res_port.restarts, res_port.total_iters) == (10, 300)
    _agree_floor(res_jax, res_port, mode)


@pytest.mark.parametrize("mode,kw", [
    ("mixed", dict(policy="relres", restart_improvement=1e-2)),
    ("baseline", dict(policy="relres", restart_improvement=1e-2)),
    ("mixed", dict(orth="mgs", policy="relres", restart_improvement=1e-2)),
    ("mixed", dict(policy="repeat", restart_improvement=1e-2)),
    ("mixed", dict(policy="orthloss", restart_improvement=1e-2)),
    ("mixed", dict(orth_steps=3)),
], ids=["relres-mixed", "relres-baseline", "mgs-relres-mixed", "repeat-mixed",
        "orthloss-mixed", "orth_steps3-mixed"])
def test_policy_history_matches_jax(mode, kw):
    res_jax, res_port = _solve_both(jax_convdiff(64, beta=2.0), mode, **kw)
    _agree_floor(res_jax, res_port, mode)
    ks = [h["k"] for h in res_port.history[:-1]]
    if kw.get("policy") in ("relres", "repeat"):
        assert min(ks) < 30  # the policy cut cycles short
    if kw.get("policy") == "repeat":
        assert all(k == ks[0] for k in ks)


def test_orthloss_trigger_every_first_step_matches_jax():
    # restart_improvement 0: loss_sq >= 0 fires at k+1 = 1 in every cycle,
    # which the port cuts after the loop; it aborts at max_restarts
    res_jax, res_port = _solve_both(jax_convdiff(32, beta=2.0), "baseline",
                                    policy="orthloss", restart_improvement=0.0,
                                    max_restarts=12)
    assert res_port.aborted and [h["k"] for h in res_port.history] == [1] * 12
    _same_cycles(res_jax, res_port, "baseline")
    xj = np.asarray(res_jax.x)
    assert np.linalg.norm(res_port.x.numpy() - xj) / np.linalg.norm(xj) <= TOL["baseline"]["x"]


def test_repeat_divergence_matches_jax():
    # tests/test_gmres.py:296-326: the first cycle's rtol=1e-2 trigger locks
    # the restart length to a small k and GMRES(k) stagnates to max_restarts
    res_jax, res_port = _solve_both(jax_convdiff(128, beta=2.0), "mixed",
                                    policy="repeat", restart_improvement=1e-2)
    assert res_port.aborted and not res_port.converged and res_port.restarts == 80
    ks = [h["k"] for h in res_port.history]
    assert all(k == ks[0] < 30 for k in ks)
    _same_cycles(res_jax, res_port, "mixed")


# (matrix, mode, orth, policy, rtol, rlen, tol, prec): the MGS and policy
# cases of tests/test_golden_oracle.py:55-67 whose preconditioner the port has
ORACLE_CASES = [
    ("convdiff24", "mixed", "mgs", "relres", 1e-2, 40, 1e-8, "identity"),
    ("convdiff24", "mixed", "cgsr", "repeat", 1e-4, 60, 1e-8, "identity"),
    ("convdiff24", "baseline", "mgs", "fixed", 0.0, 40, 1e-10, "jacobi"),
    ("convdiff24", "mixed", "cgsr", "orthloss", 1e-2, 40, 1e-8, "identity"),
    ("unstruct", "baseline", "mgs", "relres", 1e-2, 30, 1e-10, "jacobi"),
    ("convdiff24", "baseline", "mgs", "fixed", 0.0, 20, 1e-10, "ilu_jacobi"),
]


@pytest.mark.parametrize("case", ORACLE_CASES,
                         ids=["-".join(str(c) for c in c[:4]) for c in ORACLE_CASES])
def test_matches_dense_oracle(case):
    # as tests/test_golden_oracle.py holds gmres_tpu: fp rounding may shift
    # a restart boundary by one
    name, mode, orth, policy, rtol, rlen, tol, prec = case
    A = jax_convdiff(24, beta=1.0) if name == "convdiff24" else _unstructured()
    _, b = _problem(A)
    D = _dense(A)
    ilu_steps = 3 if prec == "ilu_jacobi" else 0
    ref = oracle_solve(D, b, tol=tol, rlen=rlen, max_restarts=400, orth=orth, mode=mode,
                       policy=policy, rtol=rtol,
                       inv_diag=1.0 / np.diag(D) if prec == "jacobi" else None,
                       ilu_jacobi_steps=ilu_steps)
    assert ref.converged
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth=orth, precond=prec,
        jacobi_steps=max(1, ilu_steps), policy=policy, restart_improvement=rtol,
        restart_length=rlen, tol=tol, max_restarts=400)
    A_port = csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                            n_cols=A.n_cols)
    res = gmres_tpu_torch.solve(A_port, b, cfg, device="cpu")
    assert res.converged
    assert abs(res.restarts - ref.restarts) <= 1, (res.restarts, ref.restarts)
    assert abs(res.total_iters - ref.total_iters) <= max(2, 0.05 * ref.total_iters)


# (mode, orth, precond): orthloss under CGS and under MGS, where the JAX
# package's count parts from the port's (2/14 against 2/16-17 in mixed CGS)
ORTHLOSS_ORACLE_CASES = [(mode, orth, prec) for orth, prec in (("cgs", "identity"),
                                                               ("mgs", "jacobi"))
                         for mode in ("baseline", "mixed")]


@pytest.mark.parametrize("mode,orth,prec", ORTHLOSS_ORACLE_CASES,
                         ids=["-".join(c) for c in ORTHLOSS_ORACLE_CASES])
def test_orthloss_matches_dense_oracle(mode, orth, prec):
    # the loss recurrence near its trigger is itself rounding, so the step
    # at which it fires follows the summation order: the port is held, as
    # test_matches_dense_oracle holds it, to the dense oracle within one
    # restart boundary on unstructured_mesh(1024, run=8)
    A = jax_mesh(1024, run=8)
    _, b = _problem(A)
    D = _dense(A)
    ref = oracle_solve(D, b, tol=1e-8, rlen=20, max_restarts=400, orth=orth, mode=mode,
                       policy="orthloss", rtol=1e-2,
                       inv_diag=1.0 / np.diag(D) if prec == "jacobi" else None)
    assert ref.converged
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode), orth=orth, precond=prec,
        policy="orthloss", restart_improvement=1e-2, restart_length=20, tol=1e-8,
        max_restarts=400)
    A_port = csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                            n_cols=A.n_cols)
    res = gmres_tpu_torch.solve(A_port, b, cfg, device="cpu")
    assert res.converged
    assert abs(res.restarts - ref.restarts) <= 1, (res.restarts, ref.restarts)
    assert abs(res.total_iters - ref.total_iters) <= max(2, 0.05 * ref.total_iters), (
        res.total_iters, ref.total_iters)


def test_lowsync_mgs_rule_on_both_devices():
    cfg = gmres_tpu_torch.GmresConfig(orth="mgs")
    # None: the JAX package's CPU branch (sequential) on the CPU; on a CUDA
    # device the rule measured on the H100 (sequential in both modes, PERF.md)
    assert set(LOWSYNC_MGS_DEFAULT) == {"cpu", "cuda"}
    assert use_lowsync_mgs(cfg, "cpu") is False
    assert use_lowsync_mgs(cfg, "cuda") is False
    for device in ("cpu", "cuda"):
        assert use_lowsync_mgs(cfg.with_(low_sync_mgs=True), device) is True
        assert use_lowsync_mgs(cfg.with_(low_sync_mgs=False), device) is False
        assert use_lowsync_mgs(cfg.with_(orth="cgsr", low_sync_mgs=True), device) is False
    # on the CPU, None runs exactly the sequential solve
    A = _port_dia(jax_convdiff(16, beta=2.0))
    b = np.random.default_rng(1).standard_normal(A.n_rows)
    base = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("mixed"), orth="mgs",
        precond="identity", tol=1e-8)
    auto = gmres_tpu_torch.solve(A, b, base, device="cpu")
    seq = gmres_tpu_torch.solve(A, b, base.with_(low_sync_mgs=False), device="cpu")
    icwy = gmres_tpu_torch.solve(A, b, base.with_(low_sync_mgs=True), device="cpu")
    assert torch.equal(auto.x, seq.x) and not torch.equal(auto.x, icwy.x)
