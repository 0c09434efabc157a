"""The batched multi-RHS solve (``gmres_tpu_torch.solve_batched``) on the
CPU, through the plain versions of the kernels: every case of
``tests/test_batched.py`` held against ``gmres_tpu.solve_batched`` on the
same numpy inputs (restarts, iterations and per-cycle history rows equal,
each cycle's relative residual within the tolerances of
``tests/test_torch_solver.py``) and against the port's own ``solve`` lane by
lane (the same counts, history rows and x, bit for bit: the reference test
asks x within rtol 1e-7 / atol 1e-9).

Also: REPEAT lanes whose first cycles have different lengths, ICWY and
sequential MGS, a caller-given exact-ILU DIA preconditioner (K6's plain
version lane by lane), a lane pinned to the dense oracle, a lane's bits
independent of the batch's size and of its place in it,
``build_ilu_exact(allow_fused=False)`` against the JAX package's, and K1's
lane plain versions against the JAX package's DIA SpMV and double-float
residual kernel lane by lane.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.io.synth import poisson_2d as jax_poisson
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.ops.pallas.df64_kernel import _halo_pad, merge_f64, residual_df64, split_f64
from gmres_tpu.ops.pallas.spmv_kernel import dia_spmv_pallas
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu_torch.convert import csr_from_numpy, dia_from_numpy
from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
from gmres_tpu_torch.precond import build as pbuild

from oracle_gmres import oracle_solve
from test_torch_solver import FLOOR, TOL, _dense

def _port(A):
    return csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx), np.asarray(A.vals),
                          n_cols=A.n_cols)


def _rhs_batch(A, seeds):
    xs = [gmres_tpu.rand_vect(A.n_rows, s) for s in seeds]
    return xs, np.stack([np.asarray(jax_spmv(A, jnp.asarray(x))) for x in xs])


def _configs(mode="mixed", precision=None, **kw):
    pj = precision or gmres_tpu.PrecisionSpec.from_mode(mode)
    pp = gmres_tpu_torch.PrecisionSpec(pj.outer, pj.inner, pj.precond, basis=pj.basis)
    return gmres_tpu.GmresConfig(precision=pj, **kw), gmres_tpu_torch.GmresConfig(precision=pp, **kw)


def _rows(h):
    return [(r["i"], r["k"]) for r in h]


def _same_as_single(r, one):
    """A lane against the port's solve of its b: on the CPU every operation
    of a lane is the single cycle's (K1's lane plain versions equal K1's,
    the rest is elementwise or the single cycle's own call), so the counts,
    every history row and x are equal bit for bit (the reference test asks
    x within rtol 1e-7 / atol 1e-9)."""
    assert (r.converged, r.aborted, r.diverged) == (one.converged, one.aborted, one.diverged)
    assert (r.restarts, r.total_iters) == (one.restarts, one.total_iters)
    assert r.history == one.history
    assert r.rel_prec_res == one.rel_prec_res or (r.rel_prec_res != r.rel_prec_res
                                                  and one.rel_prec_res != one.rel_prec_res)
    assert torch.equal(r.x, one.x)


def _check(A, B, kw, mode="mixed", precision=None, M=None, jax_M=None, floor=None):
    """The port's batched lanes against gmres_tpu.solve_batched (each
    cycle's relative residual within ``TOL``'s rtol, or ``floor`` of ||b|| +
    ||A||_F ||x||) and against the port's solve of each b_j; returns the
    port's results."""
    cj, cp = _configs(mode, precision, **kw)
    Ap = _port(A)
    res = gmres_tpu_torch.solve_batched(Ap, B, cp, M=M, record_history=True, device="cpu")
    ref = gmres_tpu.solve_batched(A, B, cj, M=jax_M, record_history=True)
    tol = TOL["mixed" if cp.precision.inner != "float64" else "baseline"]
    floor = floor or FLOOR["mixed" if cp.precision.inner != "float64" else "baseline"]
    assert len(res) == len(ref) == B.shape[0]
    for lane, (r, rj) in enumerate(zip(res, ref)):
        assert (r.converged, r.aborted, r.diverged) == (rj.converged, rj.aborted, rj.diverged)
        assert (r.restarts, r.total_iters) == (rj.restarts, rj.total_iters)
        assert _rows(r.history) == _rows(rj.history)
        np.testing.assert_allclose([h["rel_initial"] for h in r.history],
                                   [h["rel_initial"] for h in rj.history], rtol=tol["rel"],
                                   atol=floor)
        one = gmres_tpu_torch.solve(Ap, B[lane], cp, M=M, record_history=True, device="cpu")
        _same_as_single(r, one)
    return res


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_batched_matches_single(mode):
    A = jax_convdiff(12)
    xs, B = _rhs_batch(A, [1, 2, 3, 4])
    res = _check(A, B, dict(orth="cgsr", precond="jacobi", restart_length=15, tol=1e-8,
                            max_restarts=200), mode)
    for x_true, r in zip(xs, res):
        assert r.converged and np.linalg.norm(r.x.numpy() - x_true) < 1e-4


def test_batched_uneven_convergence():
    A = jax_poisson(12)
    b_easy = np.asarray(jax_spmv(A, jnp.asarray(gmres_tpu.rand_vect(A.n_rows, 7)))) * 1e-3
    b_hard = np.asarray(jax_spmv(A, jnp.asarray(gmres_tpu.rand_vect(A.n_rows, 8))))
    res = _check(A, np.stack([b_easy, b_hard]),
                 dict(orth="cgs", precond="jacobi", restart_length=10, tol=1e-8,
                      max_restarts=300))
    assert res[0].restarts != res[1].restarts


def test_batched_policy_relres():
    A = jax_convdiff(10)
    _, B = _rhs_batch(A, [11, 12, 13])
    res = _check(A, B, dict(orth="cgsr", precond="jacobi", policy="relres",
                            restart_improvement=0.5, restart_length=15, tol=1e-8,
                            max_restarts=300))
    assert all(r.converged for r in res)


def test_batched_policy_orthloss():
    # the loss recurrence runs per lane on its own S and basis, in the cycle
    # the single solve runs.  At restart_improvement 1e-2 the lanes are held
    # to gmres_tpu.solve_batched.  At 1e-7 the trigger cuts cycles at lengths
    # that differ between the lanes, on a loss of rounding size, where the
    # JAX package's own solve and solve_batched part ways: there each lane is
    # held to the port's solve of its b
    A = jax_convdiff(10)
    _, B = _rhs_batch(A, [21, 22, 23])
    kw = dict(orth="cgsr", precond="jacobi", policy="orthloss", restart_length=15, tol=1e-8,
              max_restarts=300)
    assert all(r.converged for r in _check(A, B, dict(kw, restart_improvement=1e-2)))
    _, cp = _configs(restart_improvement=1e-7, **kw)
    Ap = _port(A)
    res = gmres_tpu_torch.solve_batched(Ap, B, cp, record_history=True, device="cpu")
    for b, r in zip(B, res):
        assert r.converged
        _same_as_single(r, gmres_tpu_torch.solve(Ap, b, cp, record_history=True, device="cpu"))
    cut = [sorted({h["k"] for h in r.history if 0 < h["k"] < 15}) for r in res]
    assert all(cut) and len({tuple(c) for c in cut}) > 1, cut


def test_batched_max_restarts_abort():
    A = jax_poisson(12)
    _, B = _rhs_batch(A, [1, 2])
    res = _check(A, B, dict(orth="cgs", precond="identity", restart_length=5, tol=1e-12,
                            max_restarts=2))
    for r in res:
        assert not r.converged and r.aborted and r.restarts == 2 and r.total_iters == 10


def test_batched_default_config_exact_ilu():
    """The default config (exact ILU) builds M in its sweep form, as the JAX
    package does: both then apply the same factors with the same sweeps."""
    A = jax_convdiff(10)
    xs, B = _rhs_batch(A, [21, 22])
    cj, cp = _configs("mixed", restart_length=15, tol=1e-8, max_restarts=200)
    res = gmres_tpu_torch.solve_batched(_port(A), B, cp, record_history=True, device="cpu")
    ref = gmres_tpu.solve_batched(A, B, cj, record_history=True)
    for x_true, r, rj in zip(xs, res, ref):
        assert r.converged and (r.restarts, r.total_iters) == (rj.restarts, rj.total_iters)
        assert _rows(r.history) == _rows(rj.history)
        assert np.linalg.norm(r.x.numpy() - x_true) < 1e-4


def test_batched_input_validation():
    A = _port(jax_poisson(8))
    B = np.ones((1, A.n_rows))
    with pytest.raises(ValueError, match="single-device"):
        gmres_tpu_torch.solve_batched(A, B, gmres_tpu_torch.GmresConfig(axis_name="rows"),
                                      device="cpu")
    with pytest.raises(ValueError, match="df64"):
        gmres_tpu_torch.solve_batched(A, B, gmres_tpu_torch.GmresConfig(
            precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64")), device="cpu")
    with pytest.raises(ValueError, match="batch, n"):
        gmres_tpu_torch.solve_batched(A, np.zeros((A.n_rows,)), gmres_tpu_torch.GmresConfig(),
                                      device="cpu")
    # word for word the JAX package's messages
    for cfg in (dict(axis_name="rows"), dict(precision=gmres_tpu.PrecisionSpec.from_mode("df64"))):
        with pytest.raises(ValueError) as ej:
            gmres_tpu.solve_batched(jax_poisson(8), B, gmres_tpu.GmresConfig(**cfg))
        pcfg = dict(cfg)
        if "precision" in pcfg:
            pcfg["precision"] = gmres_tpu_torch.PrecisionSpec.from_mode("df64")
        with pytest.raises(ValueError) as ep:
            gmres_tpu_torch.solve_batched(A, B, gmres_tpu_torch.GmresConfig(**pcfg), device="cpu")
        assert str(ep.value) == str(ej.value)


def test_batched_compressed_basis():
    """Against gmres_tpu the cycles round against a bf16-rounded basis, and
    their relative residuals part by up to 4% at 6e-7 (2.4e-8 of ||b|| +
    ||A||_F ||x||): held at 1e-7, ten times fp32's floor."""
    A = jax_convdiff(10)
    xs, B = _rhs_batch(A, [31, 32])
    prec = dataclasses.replace(gmres_tpu.PrecisionSpec.from_mode("mixed"), basis="bfloat16")
    res = _check(A, B, dict(orth="cgsr", precond="jacobi", restart_length=15, tol=1e-8,
                            max_restarts=300), precision=prec, floor=1e-7)
    for x_true, r in zip(xs, res):
        assert r.converged and np.linalg.norm(r.x.numpy() - x_true) < 1e-3


def test_batched_list_input():
    A = jax_poisson(10)
    xs, B = _rhs_batch(A, [5, 6])
    _, cp = _configs("baseline", orth="mgs", precond="jacobi", restart_length=12, tol=1e-10,
                     max_restarts=300)
    res = gmres_tpu_torch.solve_batched(_port(A), [B[0], torch.from_numpy(B[1])], cp,
                                        device="cpu")
    whole = gmres_tpu_torch.solve_batched(_port(A), B, cp, device="cpu")
    for x_true, r, w in zip(xs, res, whole):
        assert r.converged and np.linalg.norm(r.x.numpy() - x_true) < 1e-6
        assert torch.equal(r.x, w.x)


def test_batched_repeat_lanes_with_different_first_lengths():
    """Under REPEAT each lane's later cycles run its own first cycle's
    length; the longest lane sets the loop, and a shorter lane's extra steps
    do not reach its solution."""
    A = jax_convdiff(10)
    rng = np.random.default_rng(3)
    B = np.stack([np.asarray(jax_spmv(A, jnp.asarray(gmres_tpu.rand_vect(A.n_rows, 41)))),
                  rng.standard_normal(A.n_rows), np.ones(A.n_rows)])
    res = _check(A, B, dict(orth="cgsr", precond="jacobi", policy="repeat",
                            restart_improvement=0.1, restart_length=15, tol=1e-8,
                            max_restarts=60), "baseline")
    firsts = [r.history[0]["k"] for r in res]
    assert len(set(firsts)) > 1, firsts
    for r, k0 in zip(res, firsts):
        assert all(h["k"] == k0 for h in r.history[1:] if h["k"])


@pytest.mark.parametrize("lowsync", [False, True], ids=["sequential", "icwy"])
@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_batched_mgs(mode, lowsync):
    A = jax_convdiff(12)
    _, B = _rhs_batch(A, [51, 52, 53])
    _check(A, B, dict(orth="mgs", low_sync_mgs=lowsync, precond="identity", restart_length=20,
                      tol=1e-8, max_restarts=100), mode)


def test_batched_caller_exact_ilu_lane_by_lane(monkeypatch):
    """A caller's ``ExactILUDIAPrec`` (K6's plain version here) is applied
    to each lane as the single solve applies it."""
    A = jax_convdiff(20)   # 20 levels: more than _SHALLOW_LEVELS, banded factors
    Ap = _port(A)
    M = pbuild.build_ilu_exact(Ap, torch.float32)
    assert isinstance(M, pbuild.ExactILUDIAPrec)
    _, B = _rhs_batch(A, [61, 62])
    _, cp = _configs("mixed", orth="cgsr", precond="ilu", restart_length=20, tol=1e-8,
                     max_restarts=50)
    res = gmres_tpu_torch.solve_batched(Ap, B, cp, M=M, record_history=True, device="cpu")
    for b, r in zip(B, res):
        assert r.converged
        _same_as_single(r, gmres_tpu_torch.solve(Ap, b, cp, M=M, record_history=True,
                                                 device="cpu"))


@pytest.mark.parametrize("mode", ["baseline", "mixed"])
def test_batched_lane_pinned_to_oracle(mode):
    A = jax_convdiff(12)
    xs, B = _rhs_batch(A, [71, 72])
    _, cp = _configs(mode, orth="cgsr", precond="identity", restart_length=15, tol=1e-8,
                     max_restarts=200)
    res = gmres_tpu_torch.solve_batched(_port(A), B, cp, device="cpu")
    ref = oracle_solve(_dense(A), B[1], tol=1e-8, rlen=15, max_restarts=200, orth="cgsr",
                       mode=mode)
    assert ref.converged and res[1].converged
    assert (res[1].restarts, res[1].total_iters) == (ref.restarts, ref.total_iters)
    np.testing.assert_allclose(res[1].x.numpy(), ref.x, rtol=0,
                               atol=TOL[mode]["x"] * np.abs(ref.x).max())


def test_batched_lane_bits_independent_of_batch_size_and_position():
    A = jax_convdiff(12)
    _, B = _rhs_batch(A, [81, 82, 83, 84, 85])
    _, cp = _configs("mixed", orth="cgsr", precond="jacobi", restart_length=15, tol=1e-8,
                     max_restarts=200)
    Ap = _port(A)
    b = B[0]
    alone = gmres_tpu_torch.solve_batched(Ap, b[None], cp, record_history=True, device="cpu")[0]
    five = np.stack([B[1], B[2], B[3], b, B[4]])
    third = gmres_tpu_torch.solve_batched(Ap, five, cp, record_history=True, device="cpu")[3]
    assert (alone.restarts, alone.total_iters) == (third.restarts, third.total_iters)
    assert alone.history == third.history
    assert torch.equal(alone.x, third.x)


@pytest.mark.parametrize("nx,dtype", [(10, torch.float32), (20, torch.float64),
                                      (20, torch.float32)])
def test_build_ilu_exact_sweep_form_matches_jax(nx, dtype, monkeypatch):
    import gmres_tpu.native
    from gmres_tpu.precond.build import build_ilu_exact as jax_build

    if gmres_tpu.native._lib is None:
        monkeypatch.setattr(gmres_tpu.native, "_lib_failed", True)
    A = jax_convdiff(nx)
    want = jax_build(A, np.dtype(str(dtype).removeprefix("torch.")), allow_fused=False)
    got = pbuild.build_ilu_exact(_port(A), dtype, allow_fused=False)
    assert type(got).__name__ == type(want).__name__ == "ILUJacobiPrec"
    assert got.steps == want.steps
    np.testing.assert_array_equal(got.inv_diag.numpy(), np.asarray(want.inv_diag))
    for g, w in ((got.lower, want.lower), (got.upper, want.upper)):
        rp, ci, v = g.numpy_arrays()
        nnz = int(rp[-1])
        np.testing.assert_array_equal(rp, np.asarray(w.row_ptr))
        np.testing.assert_array_equal(ci[:nnz], np.asarray(w.col_idx)[:nnz])
        np.testing.assert_array_equal(v[:nnz], np.asarray(w.vals)[:nnz])
    # allow_fused=True keeps today's routing: the K6 form where the levels are many
    fused = pbuild.build_ilu_exact(_port(A), dtype)
    assert isinstance(fused, pbuild.ExactILUDIAPrec)


def test_build_ilu_exact_sweep_form_refuses_over_budget(monkeypatch):
    import gmres_tpu.native
    from gmres_tpu.precond import build as jax_pbuild

    if gmres_tpu.native._lib is None:
        monkeypatch.setattr(gmres_tpu.native, "_lib_failed", True)
    A = jax_convdiff(20)
    monkeypatch.setattr(jax_pbuild, "_SWEEP_WORK_BUDGET", 1000)
    monkeypatch.setattr(pbuild, "_SWEEP_WORK_BUDGET", 1000)
    with pytest.raises(ValueError) as ej:
        jax_pbuild.build_ilu_exact(A, np.float32, allow_fused=False)
    with pytest.raises(ValueError) as ep:
        pbuild.build_ilu_exact(_port(A), torch.float32, allow_fused=False)
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("s", [1, 3, 8])
def test_k1_lane_plain_versions_match_k1_and_jax(s):
    """K1's lane plain versions equal K1's plain version lane by lane bit for
    bit, and the JAX package's DIA kernel (interpret mode, fp32) and
    double-float residual kernel (interpret mode) lane by lane within
    ``tests/test_torch_spmv.py``'s and ``tests/test_torch_outer.py``'s
    tolerances."""
    dia = jax_from_csr(jax_convdiff(32, beta=2.0))
    n = dia.n_rows
    rng = np.random.default_rng(s)
    data64 = np.asarray(dia.data)
    # X as the strided view the solver passes: row k of each lane's basis
    V = rng.standard_normal((s, 4, n))
    X = torch.from_numpy(V)[:, 2]
    B = torch.from_numpy(rng.standard_normal((s, n)))
    for dt in (torch.float32, torch.float64):
        data = torch.from_numpy(data64).to(dt)
        Xd = X.to(dt)
        Y = sk.dia_spmv_lanes_plain(data, dia.offsets, Xd)
        assert Y.shape == (s, n) and Y.is_contiguous()
        for j in range(s):
            assert torch.equal(Y[j], sk.dia_spmv_plain(data, dia.offsets, Xd[j]))
    d32 = dia.astype(jnp.float32)
    Y = sk.dia_spmv_lanes_plain(torch.from_numpy(np.asarray(d32.data)), dia.offsets,
                                X.to(torch.float32))
    for j in range(s):
        want = np.asarray(dia_spmv_pallas(d32, jnp.asarray(X[j].numpy().astype(np.float32)),
                                          interpret=True))
        np.testing.assert_allclose(Y[j].numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    X64 = torch.from_numpy(np.ascontiguousarray(V[:, 1]))
    R, r_ss, x_ss = sk.dia_residual_lanes_plain(torch.from_numpy(data64), dia.offsets, B, X64,
                                                torch.float32)
    pad = _halo_pad(dia.offsets)
    dh, dl = split_f64(jnp.asarray(data64))
    for j in range(s):
        r1, rs1, xs1 = sk.dia_residual_plain(torch.from_numpy(data64), dia.offsets, B[j], X64[j],
                                             torch.float32)
        assert torch.equal(R[j], r1) and r_ss[j] == rs1 and x_ss[j] == xs1
        bh, bl = split_f64(jnp.asarray(B[j].numpy()))
        xh, xl = split_f64(jnp.asarray(X64[j].numpy()))
        rh, rl, rss_j, xss_j = residual_df64(dh, dl, bh, bl, jnp.pad(xh, pad), jnp.pad(xl, pad),
                                             dia.offsets, interpret=True)
        np.testing.assert_allclose(R[j].numpy(), np.asarray(merge_f64(rh, rl)), rtol=0,
                                   atol=1e-12 * np.abs(B[j].numpy()).max())
        np.testing.assert_allclose(float(r_ss[j]), float(rss_j), rtol=1e-5)
        np.testing.assert_allclose(float(x_ss[j]), float(xss_j), rtol=1e-5)


def test_lane_chunks_cover_every_lane_once():
    # a launch takes up to 8 lanes, on the narrowest compiled width that
    # holds them: s <= 8 lanes are one launch
    for s in range(1, 40):
        chunks = sk.lane_chunks(s)
        assert [j for j0, w in chunks for j in range(j0, j0 + w)] == list(range(s))
        assert all(1 <= w <= 8 for _, w in chunks)
        assert all(sk.lane_width(w) in sk.LANE_WIDTHS and w <= sk.lane_width(w) < 2 * w
                   for _, w in chunks)
        assert len(chunks) == -(-s // 8)


def test_batched_on_cuda_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device; the contract is about machines without one")
    A = _port(jax_poisson(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        gmres_tpu_torch.solve_batched(A, np.ones((2, A.n_rows)))
