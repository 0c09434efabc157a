"""The bf16 inner tier on the CPU: the (bf16 basis, bf16 vectors) forms'
plain versions against the Pallas kernels in interpret mode, the bf16 DIA
SpMV route, the bf16 Jacobi builders and the cross-dtype apply against the
JAX package, and bf16 solves with the stall escalation as the JAX package's
``tests/test_gmres.py`` and ``tests/test_aux.py`` run them.

Tolerances.  A bf16 output of a sweep is the fp32 sum rounded to bf16; the
two sides sum in another order (and XLA on the CPU may keep fp32 between
fused bf16 operations), so the sums may differ by 1e-5 of their scale and
the rounding land one bf16 ulp apart: 2^-7 of the value itself, elementwise
(two for h = u1 + u2).  The sums of squares stay fp32: 1e-5.  K7's w is
rounded to bf16 after every row, so a flip in one row carries into the
next: one ulp per live row of the largest value the element takes.  The
inputs are an Arnoldi step's, the projection most of w.  The bf16 DIA SpMV rounds each band's product and
sum to bf16: 2^-7 of |A||x|.  Solves are held by convergence and counts,
never by bits: the bf16 solve of ``test_bf16_inner_converges`` to
convergence, a backward error <= tol and the JAX package's restarts within
one; the escalation to the JAX package's solve on the same inputs, both
converging after a stall in under 80 restarts, with the bf16 and fp32
restarts within the slack stated there, and escalation off to neither.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.io.synth import poisson_2d as jax_poisson
from gmres_tpu.ops import dia as jdia
from gmres_tpu.ops.pallas import orth_kernel as jk
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.precond import apply as japply
from gmres_tpu.precond import build as jbuild
from gmres_tpu.sparse import csr_from_coo as jax_csr_from_coo
from gmres_tpu_torch.convert import csr_from_numpy
from gmres_tpu_torch.io.synth import poisson_2d as port_poisson
from gmres_tpu_torch.ops import dia as tdia
from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
from gmres_tpu_torch.ops.cuda import orth_kernel as ok
from gmres_tpu_torch.ops.cuda.spmv_kernel import dia_spmv_plain
from gmres_tpu_torch.precond import apply as tapply
from gmres_tpu_torch.precond import build as tbuild

M1, N, LIVE = 15, 32 * 1024, 6
ULP = 2.0 ** -7


@pytest.fixture(scope="module")
def basis():
    """V (bf16, first LIVE rows orthonormal), an Arnoldi step's w = V^T u +
    e (the projection ~80% of w, so a sweep that skips it fails) and u
    (bf16): torch and jax."""
    rng = np.random.default_rng(21)
    V = np.zeros((M1, N), np.float32)
    V[:LIVE] = np.linalg.qr(rng.standard_normal((N, LIVE)))[0].T
    u = np.zeros(M1, np.float32)
    u[:LIVE] = rng.standard_normal(LIVE)
    w = V.T @ u + 0.5 * np.sqrt(LIVE / N) * rng.standard_normal(N).astype(np.float32)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (V, w, u)]
    return t, [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in t]


def _f64(a):
    return a.double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float64)


def _close(got, want, rel, scale=None):
    got, want = _f64(got), _f64(want)
    scale = np.abs(want) if scale is None else np.abs(_f64(scale))
    assert np.abs(got - want).max() <= rel * max(scale.max(), 1e-300)


def _bf16_close(got, want, scale, ulps=1, of=None):
    """A bf16 output: the fp32 sums within 1e-5 of max|scale|, then `ulps`
    bf16 ulps of `of` (want unless given) elementwise."""
    got, want = _f64(got), _f64(want)
    of = np.abs(want if of is None else _f64(of))
    bound = 1e-5 * np.abs(_f64(scale)).max() + ulps * ULP * of
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("rows", [LIVE, M1])
def test_bf16_sweeps_match_the_pallas_kernels(basis, rows):
    (V, w, u), (jV, jw, ju) = basis
    Va, wa, ua = V.float().abs(), w.float().abs(), u.float().abs()
    sw = wa + Va[:rows].t() @ ua[:rows]
    got = ok.gram(V, w, rows)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, jk._gram(jV, jw, interpret=True), Va @ wa)
    got = ok.update(V, w, u, rows)
    assert got.dtype == torch.bfloat16
    _bf16_close(got, jk._update(jV, jw, ju, interpret=True), sw)
    # u2 and the sum of squares from w' before it is rounded to bf16
    w1, u2 = ok.update_gram(V, w, u, rows)
    jw1, ju2 = jk._update_gram(jV, jw, ju, interpret=True)
    assert w1.dtype == u2.dtype == torch.bfloat16
    _bf16_close(w1, jw1, sw)
    _bf16_close(u2, ju2, Va @ sw)
    w2, ss = ok.update_sumsq(V, w, u, rows)
    jw2, jss = jk._update_sumsq(jV, jw, ju, interpret=True)
    assert w2.dtype == torch.bfloat16 and ss.dtype == torch.float32
    _bf16_close(w2, jw2, sw)
    _close(float(ss), float(jss), 1e-5)
    wf = w.float() - V[:rows].float().t() @ u[:rows].float()
    assert float(ss) == pytest.approx(float(torch.dot(wf, wf)), rel=1e-5)
    h, w3, hn = ok.cgsr2(V, w, rows)
    jh, jw3, jhn = jk.cgsr2_pallas(jV, jw, interpret=True)
    assert h.dtype == w3.dtype == hn.dtype == torch.bfloat16
    sh = Va @ (wa + Va.t() @ (Va @ wa))
    _bf16_close(h, jh, sh, ulps=2)  # u1 + u2, each rounded
    _bf16_close(w3, jw3, wa + Va.t() @ sh.abs())
    _bf16_close(hn, jhn, torch.linalg.vector_norm(wa + Va.t() @ sh.abs()))


@pytest.mark.parametrize("rows", [LIVE, M1])
def test_bf16_mgs_matches_the_pallas_kernel(basis, rows):
    # w rounded to bf16 after every row, h_j in fp32 then rounded: w' held
    # to one ulp a live row of the largest value an element takes
    (V, w, _), (jV, jw, _) = basis
    h, w2, hn = mk.mgs(V, w, rows)
    jh, jw2, jhn = jk._mgs(jV, jw, interpret=True)
    assert h.dtype == w2.dtype == hn.dtype == torch.bfloat16
    Va, wa = V.float().abs(), w.float().abs()
    sm = wa + Va[:rows].t() @ h[:rows].float().abs()
    _bf16_close(h, jh, Va @ sm)
    _bf16_close(w2, jw2, sm, ulps=LIVE, of=sm)
    _bf16_close(hn, jhn, torch.linalg.vector_norm(sm))


def test_bf16_dia_spmv_is_the_xla_formula():
    A = jax_convdiff(20, beta=2.0)
    dia = jdia.from_csr(A)
    x = rand_vect(A.n_rows, 5)
    jy = jdia.dia_spmv(dia.astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16))
    port = tdia.DIAMatrix(data=torch.from_numpy(np.asarray(dia.data)), offsets=dia.offsets,
                          n_rows=dia.n_rows, n_cols=dia.n_cols, nnz=dia.nnz)
    ty = tdia.dia_spmv(port.astype(torch.bfloat16), torch.from_numpy(x))
    assert ty.dtype == torch.bfloat16
    scale = dia_spmv_plain(port.data.abs(), port.offsets, torch.from_numpy(np.abs(x)))
    _close(ty, jy, ULP, scale)


def test_bf16_jacobi_builders_and_apply_match_gmres_tpu():
    A = jax_convdiff(16, beta=2.0)
    port_A = csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)
    jM = jbuild.build_jacobi(A, jnp.bfloat16)
    tM = tbuild.build_jacobi(port_A, torch.bfloat16)
    assert tM.inv_diag.dtype == torch.bfloat16
    assert np.array_equal(tM.inv_diag.double().numpy(), np.asarray(jM.inv_diag, np.float64))
    jMd = jbuild.build_jacobi_from_dia(jdia.from_csr(A), jnp.bfloat16)
    tMd = tbuild.build_jacobi_from_dia(tdia.from_csr(port_A), torch.bfloat16)
    assert np.array_equal(tMd.inv_diag.double().numpy(), np.asarray(jMd.inv_diag, np.float64))
    # fp32 M applied to a bf16 vector and a bf16 M to an fp32 one: cast, apply, cast back
    w = np.random.default_rng(2).standard_normal(A.n_rows)
    for jm, tm, dt, jdt in ((jbuild.build_jacobi(A, jnp.float32),
                             tbuild.build_jacobi(port_A, torch.float32),
                             torch.bfloat16, jnp.bfloat16),
                            (jM, tM, torch.float32, jnp.float32)):
        got = tapply.typesafe_apply(tm, torch.from_numpy(w).to(dt))
        want = japply.typesafe_apply(jm, jnp.asarray(w).astype(jdt))
        assert got.dtype == dt
        assert np.array_equal(got.double().numpy(), np.asarray(want, np.float64))


def _backward_error(A, x, b):
    r = b - A.to_scipy() @ x
    return np.linalg.norm(r) / (np.linalg.norm(b) + np.linalg.norm(A.vals.numpy())
                                * np.linalg.norm(x))


@pytest.mark.parametrize("precond", ["identity", "jacobi"])
def test_bf16_inner_converges(precond):
    # tests/test_gmres.py:test_bf16_inner_converges, and with bf16 Jacobi
    A = jax_poisson(12)
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(jax_spmv(A, jnp.asarray(x_true)))
    kw = dict(orth="cgsr", precond=precond, restart_length=20, tol=1e-6, max_restarts=5000)
    rj = gmres_tpu.solve(A, b, gmres_tpu.GmresConfig(
        precision=gmres_tpu.PrecisionSpec("float64", "bfloat16", "bfloat16"), **kw))
    pA = port_poisson(12)
    rt = gmres_tpu_torch.solve(pA, b, gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec("float64", "bfloat16", "bfloat16"), **kw),
        device="cpu")
    assert rj.converged and rt.converged and not rt.stalled and not rt.escalated
    assert _backward_error(pA, rt.x.numpy(), b) <= 1e-6
    assert abs(rt.restarts - rj.restarts) <= 1, (rt.restarts, rj.restarts)


def _scaled_convdiff():
    """tests/test_aux.py:test_bf16_escalation_converges_tight_tol's matrix:
    convdiff(16, beta=1) with rows and columns scaled by 10^U(0, 2)."""
    A0 = jax_convdiff(16, beta=1.0)
    n = A0.n_rows
    scale = 10.0 ** np.random.default_rng(3).uniform(0, 2.0, size=n)
    rp = np.asarray(A0.row_ptr)
    ci = np.asarray(A0.col_idx)[: A0.nnz]
    v = np.asarray(A0.vals)[: A0.nnz]
    rows = np.repeat(np.arange(n), np.diff(rp))
    A = jax_csr_from_coo(rows, ci, v * scale[rows] * scale[ci], n_rows=n)
    x_true = rand_vect(n, 42)
    return A, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


def _bf16_phase(res):
    """Restarts before the escalation mark, and after it."""
    marks = [i for i, h in enumerate(res.history) if h.get("escalated")]
    assert len(marks) == 1
    return marks[0], res.restarts - marks[0]


def test_bf16_escalation_converges_tight_tol():
    # the bf16 loop stalls, the solve continues in fp32 from its iterate and
    # converges in under 80 restarts; opting out neither escalates nor
    # converges.  Held to gmres_tpu.solve on the same inputs: where the bf16
    # cycles floor is rounding noise (the restart of the best cycle, and so
    # of the stall, moves by up to one STALL_WINDOW), and the JAX package
    # checks the stall after a chunk of cycles, the port after each, so the
    # bf16 restarts agree within STALL_WINDOW, the fp32 continuation within
    # FP32_SLACK and the total within their sum
    STALL_WINDOW, FP32_SLACK = 6, 3
    A, b = _scaled_convdiff()
    pA = csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)
    kw = dict(orth="cgsr", precond="identity", restart_length=60, tol=1e-8, max_restarts=120)
    jcfg = gmres_tpu.GmresConfig(
        precision=gmres_tpu.PrecisionSpec("float64", "bfloat16", "float32"), **kw)
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec("float64", "bfloat16", "float32"), **kw)
    rj = gmres_tpu.solve(A, b, jcfg, record_history=True)
    res = gmres_tpu_torch.solve(pA, b, cfg, record_history=True, device="cpu")
    assert rj.converged and rj.escalated and rj.restarts < 80
    assert res.converged and res.escalated and not res.stalled
    # the bf16 cycles, the mark, the fp32 cycles and the converged check
    assert res.restarts == len(res.history) - 2 and res.restarts < 80
    assert res.total_iters == sum(h["k"] for h in res.history if "k" in h)
    (jb, ja), (tb, ta) = _bf16_phase(rj), _bf16_phase(res)
    assert abs(tb - jb) <= STALL_WINDOW and abs(ta - ja) <= FP32_SLACK, ((tb, ta), (jb, ja))
    assert abs(res.restarts - rj.restarts) <= STALL_WINDOW + FP32_SLACK
    assert _backward_error(pA, res.x.numpy(), b) <= 1e-8
    # the stall: STALL_WINDOW restarts past the best, none 10% better
    rels = [h["rel_initial"] for h in res.history[:tb]]
    best = int(np.argmin(rels))
    assert len(rels) - 1 - best >= STALL_WINDOW and min(rels[best + 1:]) >= 0.9 * rels[best]
    rj_off = gmres_tpu.solve(A, b, dataclasses.replace(jcfg, bf16_escalation=False))
    res_off = gmres_tpu_torch.solve(pA, b, dataclasses.replace(cfg, bf16_escalation=False),
                                    device="cpu")
    assert not rj_off.escalated and not rj_off.converged
    assert not res_off.escalated and not res_off.converged
    assert res_off.restarts == rj_off.restarts == 120


def test_bf16_operator_stays_on_dia_or_csr():
    # DIA takes the banded operator in bf16; a pattern DIA refuses stays CSR
    # (no SELL packing for a bf16 inner operator)
    from gmres_tpu_torch.io.synth import unstructured_mesh
    from gmres_tpu_torch.sparse import CSRMatrix
    from gmres_tpu_torch.solver.gmres import prepare_operators

    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec("float64", "bfloat16", "bfloat16"))
    A_out, A_in = prepare_operators(unstructured_mesh(512, run=8), cfg, "cpu")
    assert isinstance(A_in, CSRMatrix) and A_in.vals.dtype == torch.bfloat16
    assert A_out.vals.dtype == torch.float64
    mixed = cfg.with_(precision=gmres_tpu_torch.PrecisionSpec.from_mode("mixed"))
    assert not isinstance(prepare_operators(unstructured_mesh(512, run=8), mixed, "cpu")[1],
                          CSRMatrix)


def _escalation_case():
    """The escalating bf16 solve of ``test_bf16_escalation_converges_tight_tol``
    (restart 60, tol 1e-8) and its unchecked result with history."""
    A, b = _scaled_convdiff()
    pA = csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec("float64", "bfloat16", "float32"),
        orth="cgsr", precond="identity", restart_length=60, tol=1e-8, max_restarts=120)
    full = gmres_tpu_torch.solve(pA, b, cfg, record_history=True, device="cpu")
    assert full.converged and full.escalated
    return pA, b, cfg, full


@pytest.fixture(scope="module")
def escalation_case():
    return _escalation_case()


@pytest.mark.parametrize("every", [1, 5, 10])
def test_checkpointed_escalation_equals_the_unchecked_solve(tmp_path, escalation_case, every):
    # the fp32 continuation starts from the stalled iterate with its counts
    # at zero and a file of its own, so saving changes nothing
    from gmres_tpu_torch.utils.checkpoint import CheckpointSpec, load_phase

    pA, b, cfg, full = escalation_case
    ck = CheckpointSpec(path=str(tmp_path / "bf16.ckpt"), every=every)
    res = gmres_tpu_torch.solve(pA, b, cfg, record_history=True, device="cpu", checkpoint=ck)
    assert res.converged and res.escalated
    assert (res.restarts, res.total_iters) == (full.restarts, full.total_iters)
    assert res.total_iters == sum(h["k"] for h in res.history if "k" in h)
    assert [(h.get("i"), h.get("k")) for h in res.history] == \
        [(h.get("i"), h.get("k")) for h in full.history]
    np.testing.assert_array_equal(res.x.numpy(), full.x.numpy())
    # the bf16 phase's file holds the stall, the continuation's its own counts
    bf16_restarts, _ = _bf16_phase(full)
    _, i, iters, _, stalled = load_phase(ck.path)
    assert stalled and (i, iters) == (bf16_restarts, bf16_restarts * cfg.m)
    _, i2, iters2, _, stalled2 = load_phase(ck.continuation().path)
    assert not stalled2 and i2 <= full.restarts - bf16_restarts and iters2 == i2 * cfg.m


def test_escalation_interrupted_in_its_fp32_phase_resumes(tmp_path, escalation_case):
    # a run killed three cycles into its fp32 phase (after the continuation's
    # save at its second restart) resumes from the continuation's file: the
    # bf16 phase is not run again, and the counts and x are the unchecked ones
    from gmres_tpu_torch.utils.checkpoint import CheckpointSpec, load

    pA, b, cfg, full = escalation_case
    bf16_restarts, _ = _bf16_phase(full)
    ck = CheckpointSpec(path=str(tmp_path / "kill.ckpt"), every=2)
    calls = []

    def kill(i, k, rel):
        calls.append(i)
        if len(calls) == bf16_restarts + 3:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        gmres_tpu_torch.solve(pA, b, cfg, device="cpu", checkpoint=ck, progress=kill)
    assert load(ck.continuation().path)[1:3] == (2, 2 * cfg.m)
    seen = []
    res = gmres_tpu_torch.solve(pA, b, cfg, record_history=True, device="cpu", checkpoint=ck,
                                progress=lambda i, k, rel: seen.append(i))
    assert res.converged and res.escalated
    assert (res.restarts, res.total_iters) == (full.restarts, full.total_iters)
    assert seen == list(range(2, full.restarts - bf16_restarts))
    assert res.history[0] == {"escalated": True}
    # the bf16 phase and the continuation's two saved cycles, then the history
    assert res.total_iters == (bf16_restarts + 2) * cfg.m + sum(h["k"] for h in res.history
                                                                if "k" in h)
    np.testing.assert_array_equal(res.x.numpy(), full.x.numpy())
