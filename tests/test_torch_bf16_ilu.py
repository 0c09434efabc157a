"""The bf16 ILU preconditioners (bf16 ILU-Jacobi and bf16 exact ILU) on the
CPU, held to ``gmres_tpu`` with the same seeded numpy inputs.

- Factors: the port's bf16 factors, lower, upper and inverse diagonal, are
  bit for bit the JAX builder's (the pivot floor eps(bf16) * max row
  1-norm, the fp64 factor rounded to bf16), and so are factors carried
  across from JAX arrays (``convert``).  The JAX package reaches its bf16
  eps through ``np.finfo(ml_dtypes.bfloat16)``, which numpy 2 refuses
  ("not inexact"), so as written its bf16 ILU builders raise on this
  machine; while a test here runs, ``np.finfo`` answers ``ml_dtypes.finfo``
  for that one type, the eps 2^-7 the JAX code means
  (``gmres_tpu/precond/ilu0.py:84``).  Nothing in the JAX package changes.
- Exact ILU: the JAX package's branch (shallow sweeps, full sweeps,
  level-scheduled, refusal) at every level count tested, with the work
  budget scaled so that a small matrix sits on the branch the 262K and 1M
  problems take; a bf16 M never takes the K6 form.
- Solves: counts within one restart of ``gmres_tpu.solve`` (both sides
  round bf16 alike, but sum in other orders), the backward error within
  tol.  The dense oracle (``tests/oracle_gmres.py``) runs an fp32 or fp64
  M only, so it cannot take a bf16 ILU: the factors are held to its dense
  ILU(0) (``_ilu0_dense``) rounded to bf16 instead, bit for bit.
- The stall escalation with a bf16 M: within the bf16 window of
  ``tests/test_torch_bf16.py`` (bf16 restarts within 6 of the JAX
  package's), with the JAX package checking the stall every cycle
  (``host_sync_every=1``) as the port does.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu.native as jax_native
import gmres_tpu_torch
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.precond import build as jax_build
from gmres_tpu.precond import level_ilu as jax_level
from gmres_tpu.precond.apply import typesafe_apply as jax_typesafe_apply
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu.sparse import csr_from_dense as jax_csr_from_dense
from gmres_tpu_torch import convert
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.precond import build as port_build
from gmres_tpu_torch.precond.apply import typesafe_apply
from gmres_tpu_torch.precond.level_ilu import LevelILUPrec
from gmres_tpu_torch.sparse import CSRMatrix

from oracle_gmres import _ilu0_dense

BF16 = torch.bfloat16
ULP = 2.0 ** -7
# restarts a bf16 stall may move by (tests/test_torch_bf16.py:217-254)
STALL_WINDOW = 6


@pytest.fixture(autouse=True)
def jax_bf16_ilu(monkeypatch):
    """The JAX package's numpy ILU path, with ``np.finfo`` answering for
    ml_dtypes' bfloat16 (see the module docstring)."""
    if jax_native._lib is None:
        monkeypatch.setattr(jax_native, "_lib_failed", True)
    finfo = np.finfo

    def bf16_finfo(dtype):
        if np.dtype(dtype) == np.dtype(ml_dtypes.bfloat16):
            return ml_dtypes.finfo(ml_dtypes.bfloat16)
        return finfo(dtype)

    monkeypatch.setattr(np, "finfo", bf16_finfo)


def _port_csr(A):
    return convert.csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)


def _bits(t):
    """A bf16 tensor or ml_dtypes array as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _boost_matrix():
    # pivot (1, 1): 2 - (1/2)*4 = 0 -> boosted to eps(bf16) * 6
    return jax_csr_from_dense(np.array([[2.0, 4.0, 0.0], [1.0, 2.0, 1.0], [0.0, 1.0, 3.0]]))


MATRICES = {
    "convdiff": lambda: jax_synth.convection_diffusion_2d(12, beta=2.0),
    "poisson": lambda: jax_synth.poisson_2d(9, 14),
    "random": lambda: jax_synth.random_sparse(200, row_nnz=5, seed=3),
    "boost": _boost_matrix,
}


def _assert_same_factors(got, want):
    for g, w in ((got.lower, want.lower), (got.upper, want.upper)):
        assert g.vals.dtype == BF16
        assert np.array_equal(g.row_ptr.numpy(), np.asarray(w.row_ptr))
        assert np.array_equal(g.col_idx.numpy(), np.asarray(w.col_idx)[: w.nnz])
        assert np.array_equal(_bits(g.vals), _bits(np.asarray(w.vals)[: w.nnz]))
    assert got.inv_diag.dtype == BF16
    assert np.array_equal(_bits(got.inv_diag), _bits(want.inv_diag))


@pytest.mark.parametrize("case", list(MATRICES))
def test_bf16_factors_bit_equal_to_gmres_tpu(case):
    A = MATRICES[case]()
    want = jax_build.build_ilu_jacobi(A, jnp.bfloat16, steps=3)
    got = port_build.build_ilu_jacobi(_port_csr(A), BF16, 3)
    assert got.steps == 3
    _assert_same_factors(got, want)
    if case == "boost":
        # the pivot floor in bf16: eps 2^-7 times the largest row 1-norm, 6
        assert float(got.upper.vals[2]) == 2.0 ** -7 * 6.0


def test_bf16_factors_are_the_dense_oracles_rounded():
    # the oracle's dense ILU(0) in fp64 (no pivot needs the floor here),
    # rounded to bf16 by torch: the port's factors bit for bit, and the
    # inverse diagonal that of the rounded pivots
    A = jax_synth.convection_diffusion_2d(8, beta=2.0)
    F = _ilu0_dense(A.to_scipy().toarray())
    M = port_build.build_ilu_jacobi(_port_csr(A), BF16, 1)
    rows = np.repeat(np.arange(A.n_rows), np.diff(np.asarray(A.row_ptr)))
    cols = np.asarray(A.col_idx)[: A.nnz]
    want = torch.from_numpy(F[rows, cols]).to(BF16)
    below = cols < rows
    got = torch.zeros(A.nnz, dtype=BF16)
    got[torch.from_numpy(below)] = M.lower.vals
    got[torch.from_numpy(~below)] = M.upper.vals
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # the inverse of each rounded pivot, taken in fp64 and rounded
    inv = (1.0 / torch.from_numpy(np.diag(F).copy()).to(BF16).double()).to(BF16)
    assert torch.equal(M.inv_diag.view(torch.int16), inv.view(torch.int16))


def test_jax_bf16_preconditioners_carried_across_bit_for_bit():
    # np.asarray of a JAX bf16 array has ml_dtypes' dtype, which
    # torch.from_numpy refuses; convert moves its bits
    A = jax_synth.convection_diffusion_2d(12, beta=2.0)
    Mj = jax_build.build_ilu_jacobi(A, jnp.bfloat16, steps=3)
    tri = [(np.asarray(t.row_ptr), np.asarray(t.col_idx), np.asarray(t.vals))
           for t in (Mj.lower, Mj.upper)]
    carried = convert.ilu_jacobi_from_numpy(*tri, np.asarray(Mj.inv_diag), 3)
    _assert_same_factors(carried, Mj)
    _assert_same_factors(port_build.build_ilu_jacobi(_port_csr(A), BF16, 3), Mj)
    Jj = jax_build.build_jacobi(A, jnp.bfloat16)
    J = convert.jacobi_from_numpy(np.asarray(Jj.inv_diag))
    assert J.inv_diag.dtype == BF16
    assert np.array_equal(_bits(J.inv_diag), _bits(Jj.inv_diag))
    assert np.array_equal(_bits(port_build.build_jacobi(_port_csr(A), BF16).inv_diag),
                          _bits(Jj.inv_diag))


def _chain_matrix(n=64):
    """An upper chain of n levels under a lower one of n/2: the
    level-scheduled work (32 * 62 + 64 * 127 = 10,112) is below the full
    sweeps' (64 levels * 189 nonzeros = 12,096)."""
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[2:]])
    cols = np.concatenate([i, i[:-1] + 1, i[2:] - 2])
    vals = np.concatenate([np.full(n, 4.0), np.full(n - 1, -1.0), np.full(n - 2, -0.5)])
    return jax_csr_from_coo(rows, cols, vals, n_rows=n)


# branch -> (matrix, work budget).  convdiff(512) (1023 levels x 1,309,700
# nonzeros = 1.34e9 against the 2e9 budget) takes the sweep form: so does
# convdiff(16) (31 levels x 1,216) under a budget in the same ratio.
# convdiff@1M (2047 x 5,238,784 = 1.07e10) is over the budget and its
# level-scheduled work (~6.7e8 in chunks of 65,536 rows) within it: so is
# the chain matrix under 11,000; under 5,000 both are over and the build
# refuses.
ROUTES = {
    "shallow": (lambda: jax_synth.convection_diffusion_2d(4), None),
    "sweeps": (lambda: jax_synth.convection_diffusion_2d(16), int(31 * 1216 * 2e9 / 1.34e9)),
    "level_scheduled": (_chain_matrix, 11_000),
    "refused": (_chain_matrix, 5_000),
}


@pytest.mark.parametrize("branch", list(ROUTES))
def test_bf16_exact_ilu_takes_the_jax_packages_branch(branch, monkeypatch):
    make, budget = ROUTES[branch]
    A = make()
    if budget is not None:
        monkeypatch.setattr(jax_build, "_SWEEP_WORK_BUDGET", budget)
        monkeypatch.setattr(port_build, "_SWEEP_WORK_BUDGET", budget)
    if branch == "refused":
        with pytest.raises(ValueError) as want:
            jax_build.build_ilu_exact(A, jnp.bfloat16)
        with pytest.raises(ValueError) as got:
            port_build.build_ilu_exact(_port_csr(A), BF16)
        assert str(got.value) == str(want.value)
        return
    Mj = jax_build.build_ilu_exact(A, jnp.bfloat16)
    M = port_build.build_ilu_exact(_port_csr(A), BF16)
    assert type(M).__name__ == type(Mj).__name__
    if branch == "level_scheduled":
        assert isinstance(M, LevelILUPrec)
        for name in ("l_cols", "l_segs", "l_rows", "u_cols", "u_segs", "u_rows"):
            assert np.array_equal(getattr(M, name).numpy(), np.asarray(getattr(Mj, name)))
        for name in ("l_vals", "u_vals", "u_invd", "inv_diag"):
            assert np.array_equal(_bits(getattr(M, name)), _bits(getattr(Mj, name))), name
        assert M.l_sweeps == tuple(np.asarray(Mj.l_sweeps).tolist())
        assert M.u_sweeps == tuple(np.asarray(Mj.u_sweeps).tolist())
        return
    assert M.steps == Mj.steps == (7 if branch == "shallow" else 31)
    _assert_same_factors(M, Mj)


def test_bf16_exact_ilu_never_takes_k6():
    # the fp32 and fp64 builds of the same banded factors take the K6 form;
    # bf16 takes the sweeps, as the JAX package's fp32-only gate sends it
    A = _port_csr(jax_synth.convection_diffusion_2d(16))
    assert isinstance(port_build.build_ilu_exact(A, torch.float32),
                      port_build.ExactILUDIAPrec)
    M = port_build.build_ilu_exact(A, BF16)
    assert isinstance(M, port_build.ILUJacobiPrec) and M.inv_diag.dtype == BF16
    # repacked: bf16 DIA bands (the plain-torch route), never sliced ELL
    Mf = port_build.sell_pack_factors(port_build.optimize_precond_format(M))
    assert isinstance(Mf.lower, DIAMatrix) and Mf.lower.data.dtype == BF16
    unstructured = _port_csr(jax_synth.unstructured_mesh(1000, run=3))
    Mu = port_build.build_ilu_jacobi(unstructured, BF16, 3)
    assert port_build.sell_pack_factors(port_build.optimize_precond_format(Mu)) is Mu
    assert isinstance(Mu.lower, CSRMatrix)


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_bf16_ilu_applied_to_fp32_vectors_as_gmres_tpu(fmt):
    # typesafe_apply: w cast to bf16, the sweeps in bf16, cast back.  Each
    # sweep's SpMV and update round to bf16 on both sides (XLA may keep
    # fp32 between fused operations): held to 2^-7 per sweep of the
    # result's scale
    A = jax_synth.convection_diffusion_2d(16, beta=2.0)
    Mj = jax_build.build_ilu_jacobi(A, jnp.bfloat16, steps=3)
    M = port_build.build_ilu_jacobi(_port_csr(A), BF16, 3)
    if fmt == "dia":
        Mj = jax_build.optimize_precond_format(Mj)
        M = port_build.optimize_precond_format(M)
        assert isinstance(M.lower, DIAMatrix)
    w = np.random.default_rng(2).standard_normal(A.n_rows).astype(np.float32)
    got = typesafe_apply(M, torch.from_numpy(w))
    want = np.asarray(jax_typesafe_apply(Mj, jnp.asarray(w)), np.float64)
    assert got.dtype == torch.float32
    assert np.abs(got.double().numpy() - want).max() <= 6 * ULP * np.abs(want).max()


def _problem(A):
    return np.asarray(jax_spmv(A, jnp.asarray(rand_vect(A.n_rows, 42))))


def _backward_error(A, x, b):
    r = b - A.to_scipy() @ x
    return np.linalg.norm(r) / (np.linalg.norm(b) + np.linalg.norm(A.vals.numpy())
                                * np.linalg.norm(x))


TIERS = {"bf16": ("float64", "bfloat16", "bfloat16"),      # the bf16 inner tier
         "fp32-bf16M": ("float64", "float32", "bfloat16")}  # fp32 inner, bf16 M


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("precond", ["ilu_jacobi", "ilu"])
def test_bf16_ilu_solve_matches_gmres_tpu(precond, tier):
    A = jax_synth.convection_diffusion_2d(16, beta=2.0)
    b = _problem(A)
    kw = dict(orth="cgsr", precond=precond, jacobi_steps=3, restart_length=20, tol=1e-8,
              max_restarts=100)
    rj = gmres_tpu.solve(A, b, gmres_tpu.GmresConfig(
        precision=gmres_tpu.PrecisionSpec(*TIERS[tier]), **kw))
    pA = _port_csr(A)
    rt = gmres_tpu_torch.solve(pA, b, gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec(*TIERS[tier]), **kw), device="cpu")
    assert rj.converged and rt.converged and not rt.escalated and not rj.escalated
    assert abs(rt.restarts - rj.restarts) <= 1, (rt.restarts, rj.restarts)
    assert _backward_error(pA, rt.x.numpy(), b) <= 1e-8


def _scaled_convdiff():
    """convdiff(16, beta=1) with rows and columns scaled by 10^U(0, 2): a
    bf16 ILU-Jacobi(5) solve stalls there, in both packages."""
    A0 = jax_synth.convection_diffusion_2d(16, beta=1.0)
    n = A0.n_rows
    scale = 10.0 ** np.random.default_rng(3).uniform(0, 2.0, size=n)
    rp = np.asarray(A0.row_ptr)
    ci = np.asarray(A0.col_idx)[: A0.nnz]
    v = np.asarray(A0.vals)[: A0.nnz]
    rows = np.repeat(np.arange(n), np.diff(rp))
    return jax_csr_from_coo(rows, ci, v * scale[rows] * scale[ci], n_rows=n)


ESCALATION = dict(orth="cgsr", precond="ilu_jacobi", jacobi_steps=5, restart_length=30,
                  tol=1e-8, max_restarts=40, host_sync_every=1)


def _escalation_configs():
    spec = ("float64", "bfloat16", "bfloat16")
    return (gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec(*spec), **ESCALATION),
            gmres_tpu_torch.GmresConfig(precision=gmres_tpu_torch.PrecisionSpec(*spec),
                                        **ESCALATION))


def _bf16_restarts(res):
    marks = [i for i, h in enumerate(res.history) if h.get("escalated")]
    assert len(marks) == 1
    return marks[0]


@pytest.fixture(scope="module")
def escalation_case():
    """The stalling bf16 ILU-Jacobi solve: (port CSR, b, port config, its
    unchecked result with history)."""
    A = _scaled_convdiff()
    pA, b = _port_csr(A), _problem(A)
    cfg = _escalation_configs()[1]
    return A, pA, b, cfg, gmres_tpu_torch.solve(pA, b, cfg, record_history=True, device="cpu")


def test_bf16_ilu_escalation_without_m_rebuilds_m_as_gmres_tpu(escalation_case, monkeypatch):
    # with no M=, both packages build the bf16 factors for the bf16 phase and
    # build them again, in bf16, for the fp32 continuation (the caller's
    # precond dtype); the bf16 ILU-Jacobi(5) is a poor preconditioner here in
    # any inner dtype, so neither continuation converges in the 40 restarts:
    # what is held is where the escalation comes and the counts
    A, pA, b, cfg, full = escalation_case
    rj = gmres_tpu.solve(A, b, _escalation_configs()[0], record_history=True)
    assert rj.escalated and full.escalated and not full.stalled
    assert not rj.converged and not full.converged
    assert full.restarts == rj.restarts == cfg.max_restarts
    assert full.total_iters == sum(h["k"] for h in full.history if "k" in h)
    assert abs(_bf16_restarts(full) - _bf16_restarts(rj)) <= STALL_WINDOW
    builds = []
    real = gmres_tpu_torch.solver.gmres.build_preconditioner
    monkeypatch.setattr(gmres_tpu_torch.solver.gmres, "build_preconditioner",
                        lambda A_, c: builds.append(c.precision) or real(A_, c))
    again = gmres_tpu_torch.solve(pA, b, cfg, device="cpu")
    assert [(p.inner, p.precond) for p in builds] == [("bfloat16", "bfloat16"),
                                                     ("float32", "bfloat16")]
    assert (again.restarts, again.total_iters) == (full.restarts, full.total_iters)


def test_bf16_ilu_escalation_with_m_keeps_the_callers_m(escalation_case, monkeypatch):
    # the port's continuation applies the caller's M (the JAX package drops
    # it and rebuilds from cfg, gmres_tpu/solver/gmres.py:1174-1186): no M is
    # built in either phase.  The caller's M here is the one the build makes,
    # so the solve is the unchecked one bit for bit
    _, pA, b, cfg, full = escalation_case
    M = port_build.build_preconditioner(pA, cfg)
    builds = []
    monkeypatch.setattr(gmres_tpu_torch.solver.gmres, "build_preconditioner",
                        lambda *a: builds.append(a))
    res = gmres_tpu_torch.solve(pA, b, cfg, M=M, record_history=True, device="cpu")
    assert builds == [] and res.escalated
    assert (res.restarts, res.total_iters) == (full.restarts, full.total_iters)
    np.testing.assert_array_equal(res.x.numpy(), full.x.numpy())


@pytest.mark.parametrize("every", [1, 5])
def test_checkpointed_bf16_ilu_escalation_equals_the_unchecked_solve(tmp_path, escalation_case,
                                                                     every):
    from gmres_tpu_torch.utils.checkpoint import CheckpointSpec, load_phase

    _, pA, b, cfg, full = escalation_case
    ck = CheckpointSpec(path=str(tmp_path / "bf16ilu.ckpt"), every=every)
    res = gmres_tpu_torch.solve(pA, b, cfg, record_history=True, device="cpu", checkpoint=ck)
    assert res.escalated
    assert (res.restarts, res.total_iters) == (full.restarts, full.total_iters)
    assert [(h.get("i"), h.get("k")) for h in res.history] == \
        [(h.get("i"), h.get("k")) for h in full.history]
    np.testing.assert_array_equal(res.x.numpy(), full.x.numpy())
    bf16_restarts = _bf16_restarts(full)
    _, i, iters, _, stalled = load_phase(ck.path)
    assert stalled and (i, iters) == (bf16_restarts, bf16_restarts * cfg.m)


@pytest.mark.parametrize("tier", list(TIERS))
def test_solve_batched_with_a_bf16_ilu_m(tier):
    # each lane has its solve's counts and, on the CPU, its bits
    A = jax_synth.convection_diffusion_2d(12, beta=2.0)
    pA = _port_csr(A)
    B = np.stack([np.asarray(jax_spmv(A, jnp.asarray(rand_vect(A.n_rows, s))))
                  for s in (40, 41, 42)])
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec(*TIERS[tier]), orth="cgsr",
        precond="ilu_jacobi", jacobi_steps=3, restart_length=15, tol=1e-7, max_restarts=60,
        bf16_escalation=False)
    M = port_build.build_preconditioner(pA, cfg)
    lanes = gmres_tpu_torch.solve_batched(pA, B, cfg, M=M, device="cpu")
    for lane, b in zip(lanes, B):
        one = gmres_tpu_torch.solve(pA, b, cfg, M=M, device="cpu")
        assert lane.converged and one.converged
        assert (lane.restarts, lane.total_iters) == (one.restarts, one.total_iters)
        np.testing.assert_array_equal(lane.x.numpy(), one.x.numpy())


def test_level_scheduled_bf16_ilu_carried_across(monkeypatch):
    # the JAX package's bf16 LevelILUPrec, carried by convert, applies as the
    # port's own build of it (bit-equal arrays)
    monkeypatch.setattr(jax_build, "_SWEEP_WORK_BUDGET", 11_000)
    monkeypatch.setattr(port_build, "_SWEEP_WORK_BUDGET", 11_000)
    A = _chain_matrix()
    Lj = jax_build.build_ilu_exact(A, jnp.bfloat16)
    assert isinstance(Lj, jax_level.LevelILUPrec)
    fields = ("l_cols", "l_vals", "l_segs", "l_rows", "l_sweeps", "u_cols", "u_vals",
              "u_segs", "u_rows", "u_sweeps", "u_invd", "inv_diag")
    carried = convert.level_ilu_from_numpy(Lj.l_rows_max, Lj.u_rows_max, Lj.n,
                                           **{f: np.asarray(getattr(Lj, f)) for f in fields})
    own = port_build.build_ilu_exact(_port_csr(A), BF16)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(A.n_rows)).to(BF16)
    got = typesafe_apply(carried, w)
    assert got.dtype == BF16
    assert torch.equal(got.view(torch.int16), typesafe_apply(own, w).view(torch.int16))
    assert own.l_vals.dtype == BF16
