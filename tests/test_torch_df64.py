"""The df64 tier of the port on the CPU, against the JAX package.

- Kernels K8-K11 and K4's pair mode through their plain versions: K8's
  against ``_dia_spmv_df64`` and K9-K11's against ``df_gram_pallas``,
  ``df_update_gram_pallas`` and ``df_update_sumsq_pallas``, all in interpret
  mode, and K4's against x + merge(``df_basis_comb``).
- ``ops/df64.py`` against ``gmres_tpu.ops.df64`` function by function.
- Whole solves against the JAX package's df64 solves, the port's own
  baseline and the dense oracle (``tests/oracle_gmres.py``, whose
  "single-prec" mode is the df64 tier's fp64 solver with an fp32
  preconditioner).

Tolerances: a pair carries about 2^-48 relative, and the port and the JAX
package sum in other orders (the JAX package's Pallas kernels by lanes and
blocks, its jnp path by a halving tree over the rows where the port goes row
by row), so sums are held to 1e-13 of the sum of the terms' magnitudes
(``gmres_tpu``'s own ``tests/test_df64_orth_kernels.py`` holds its kernels
to rtol = atol = 1e-13).  Where both run the same chain in the same order
(the error-free transforms themselves, eager JAX against eager torch), the
results are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.ops import df64 as jdf
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.ops.pallas import df64_kernel as jk
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu_torch.convert import (
    csr_from_numpy,
    df64_dia_from_numpy,
    dia_from_numpy,
    jacobi_from_numpy,
)
from gmres_tpu_torch.io.synth import convection_diffusion_2d, unstructured_mesh
from gmres_tpu_torch.ops import df64 as pdf
from gmres_tpu_torch.ops import eft
from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
from gmres_tpu_torch.ops.cuda import df64_spmv_kernel as ds
from gmres_tpu_torch.ops.cuda.outer_kernel import basis_axpy_pair_plain
from gmres_tpu_torch.ops.dia import DF64Dia, DIAMatrix
from gmres_tpu_torch.ops.sell import SELLMatrix
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.precond.build import IdentityPrec
from gmres_tpu_torch.solver.gmres import prepare_operators

from oracle_gmres import oracle_solve

RTOL = 1e-13


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _pair(x):
    """(hi, lo) of an fp64 numpy array, as torch tensors and as jax arrays."""
    th, tl = eft.split_f64(torch.from_numpy(np.asarray(x, dtype=np.float64)))
    return (th, tl), (jnp.asarray(th.numpy()), jnp.asarray(tl.numpy()))


def _m(h, l):
    return np.asarray(h, np.float64) + np.asarray(l, np.float64)


def _close(got, want, scale):
    """|got - want| <= RTOL * max|scale| elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= RTOL * max(np.abs(np.asarray(scale)).max(), 1e-300)


def _basis(m1, n, live, seed):
    """V (m1, n) with `live` orthonormal rows and the rest zero, and w."""
    rng = np.random.default_rng(seed)
    V = np.zeros((m1, n))
    V[:live] = np.linalg.qr(rng.standard_normal((n, live)))[0].T
    return V, rng.standard_normal(n)


def test_error_free_transforms_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))
    b = rng.standard_normal(4096)
    (th_a, tl_a), (jh_a, jl_a) = _pair(a)
    (th_b, tl_b), (jh_b, jl_b) = _pair(b)
    want = jk.split_f64(jnp.asarray(a))
    assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip((th_a, tl_a), want))
    np.testing.assert_allclose(eft.merge_f64(th_a, tl_a).numpy(), a, rtol=4e-15)
    for got, want in ((eft.two_sum(th_a, th_b), jk._two_sum(jh_a, jh_b)),
                      (eft.two_prod(th_a, th_b), jk._two_prod(jh_a, jh_b)),
                      (eft.df_add(th_a, tl_a, th_b, tl_b), jk._df_add(jh_a, jl_a, jh_b, jl_b)),
                      (eft.df_mul(th_a, tl_a, th_b, tl_b), jk._df_mul(jh_a, jl_a, jh_b, jl_b))):
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))


def _jax_df64_dia(nx):
    A = jax_from_csr(jax_convdiff(nx, beta=3.0))
    D = jk.DF64Dia.from_dia(A)
    return A, D, df64_dia_from_numpy(np.asarray(D.data_hi), np.asarray(D.data_lo), D.offsets,
                                     D.n_rows, D.n_cols, D.nnz)


@pytest.mark.parametrize("nx", [17, 183])
def test_dia_spmv_df64_twin_matches_pallas(nx):
    # n = 289 and 33,489: neither is a multiple of the Pallas kernel's
    # 1024-lane or 32K block (the second spans two blocks)
    A, D, P = _jax_df64_dia(nx)
    assert np.array_equal(P.data_hi.numpy(), np.asarray(D.data_hi))
    x = np.random.default_rng(nx).standard_normal(A.n_rows)
    (xh, xl), _ = _pair(x)
    yh, yl = ds.dia_spmv_df64_plain(P.data_hi, P.data_lo, P.offsets, xh, xl)
    # the kernel on the padded operands, as dia_spmv_df64 calls it
    n = A.n_rows
    block = min(jk._BLOCK, jk._round_up(n, 1024))
    n_pad, pad = jk._round_up(n, block), jk._halo_pad(D.offsets)
    jxh, jxl = jk.split_f64(jnp.asarray(x))
    jyh, jyl = jk._dia_spmv_df64(
        jnp.pad(D.data_hi, ((0, 0), (0, n_pad - n))), jnp.pad(D.data_lo, ((0, 0), (0, n_pad - n))),
        jnp.pad(jxh, (pad, pad + n_pad - n)), jnp.pad(jxl, (pad, pad + n_pad - n)), D.offsets,
        interpret=True)
    absA = dia_from_numpy(np.abs(np.asarray(A.data, np.float64)), D.offsets, n, n, D.nnz)
    scale = spmv(absA, torch.from_numpy(np.abs(x))).numpy()  # |A| |x|
    _close(eft.merge_f64(yh, yl).numpy(), _m(jyh[:n], jyl[:n]), scale)
    # against the fp64 product, and far closer to it than fp32 is
    # (tests/test_df64.py:25-43)
    y64 = np.asarray(jax_spmv(A.astype(jnp.float64), jnp.asarray(x)))
    y32 = np.asarray(jax_spmv(A.astype(jnp.float32), jnp.asarray(x, jnp.float32)), np.float64)
    s = np.abs(y64).max()
    err_df = np.abs(eft.merge_f64(yh, yl).numpy() - y64).max() / s
    assert err_df < 1e-12 and err_df < 1e-4 * np.abs(y32 - y64).max() / s


def test_df64_dia_from_dia_matches_jax():
    A, D, P = _jax_df64_dia(20)
    port = DF64Dia.from_dia(dia_from_numpy(np.asarray(A.data), A.offsets, A.n_rows, A.n_cols,
                                           A.nnz))
    assert port.offsets == P.offsets and (port.n_rows, port.nnz) == (P.n_rows, P.nnz)
    assert torch.equal(port.data_hi, P.data_hi) and torch.equal(port.data_lo, P.data_lo)
    # ||A||_F from the fp64 merge, not from hi
    np.testing.assert_allclose(float(torch.linalg.norm(port.vals)),
                               np.linalg.norm(np.asarray(A.data)), rtol=1e-15)
    assert port.vals.dtype == torch.float64


SWEEPS = pytest.mark.parametrize("m1,n,live", [(7, 1024, 4), (31, 4096, 16)])


@SWEEPS
def test_df_gram_twin_matches_pallas(m1, n, live):
    V, w = _basis(m1, n, live, seed=m1)
    (Vh, Vl), (jVh, jVl) = _pair(V)
    (wh, wl), (jwh, jwl) = _pair(w)
    u = dk.df_gram_plain(Vh, Vl, wh, wl, live)
    assert u.dtype == torch.float64 and not u[live:].any()
    want = np.asarray(jk.df_gram_pallas(jVh, jVl, jwh, jwl, interpret=True))
    np.testing.assert_allclose(u.numpy(), want, rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(u.numpy(), V @ w, rtol=RTOL, atol=RTOL)


@SWEEPS
def test_df_update_gram_twin_matches_pallas(m1, n, live):
    V, w = _basis(m1, n, live, seed=m1 + 1)
    (Vh, Vl), (jVh, jVl) = _pair(V)
    (wh, wl), (jwh, jwl) = _pair(w)
    u = V @ w
    woh, wol, u2 = dk.df_update_gram_plain(Vh, Vl, wh, wl, torch.from_numpy(u), live)
    jwoh, jwol, ju2 = jk.df_update_gram_pallas(jVh, jVl, jwh, jwl, jnp.asarray(u),
                                               interpret=True)
    scale = np.abs(w) + np.abs(u) @ np.abs(V)
    _close(_m(woh, wol), _m(jwoh, jwol), scale)
    np.testing.assert_allclose(u2.numpy(), np.asarray(ju2), rtol=RTOL, atol=RTOL)
    assert not u2[live:].any()


@SWEEPS
def test_df_update_sumsq_twin_matches_pallas(m1, n, live):
    V, w = _basis(m1, n, live, seed=m1 + 2)
    (Vh, Vl), (jVh, jVl) = _pair(V)
    (wh, wl), (jwh, jwl) = _pair(w)
    u = V @ w
    woh, wol, ss = dk.df_update_sumsq_plain(Vh, Vl, wh, wl, torch.from_numpy(u), live)
    jwoh, jwol, jss = jk.df_update_sumsq_pallas(jVh, jVl, jwh, jwl, jnp.asarray(u),
                                                interpret=True)
    _close(_m(woh, wol), _m(jwoh, jwol), np.abs(w) + np.abs(u) @ np.abs(V))
    np.testing.assert_allclose(float(ss), float(jss), rtol=RTOL)
    w1 = w - u @ V
    np.testing.assert_allclose(float(ss), float(w1 @ w1), rtol=RTOL)


@pytest.mark.parametrize("rows", [1, 20])
def test_basis_axpy_pair_twin_matches_jax_comb(rows):
    rng = np.random.default_rng(rows)
    n = 3000
    V = rng.standard_normal((21, n))
    y = rng.standard_normal(rows)
    x = rng.random(n)
    (Vh, Vl), (jVh, jVl) = _pair(V)
    got = basis_axpy_pair_plain(torch.from_numpy(x.copy()), Vh, Vl, torch.from_numpy(y))
    want = x + np.asarray(jk.merge_f64(*jdf.df_basis_comb(jVh[:rows], jVl[:rows],
                                                           jnp.asarray(y))))
    bound = RTOL * (np.abs(y) @ np.abs(V[:rows]))
    assert np.all(np.abs(got.numpy() - want) <= bound)


# --- ops/df64.py against gmres_tpu.ops.df64 --------------------------------

M1, N, K = 9, 2048, 5


@pytest.fixture(scope="module")
def pair_basis():
    V, w = _basis(M1, N, K + 1, seed=3)
    return V, w, _pair(V), _pair(w)


def test_df_sum_dot_norm_match_jax(pair_basis):
    V, w, _, ((wh, wl), (jwh, jwl)) = pair_basis
    (vh, vl), (jvh, jvl) = _pair(V[2])
    sh, sl = eft.df_sum(wh, wl)
    jsh, jsl = jdf.df_sum(jwh, jwl)
    assert np.array_equal(sh.numpy(), np.asarray(jsh)) and np.array_equal(sl.numpy(),
                                                                          np.asarray(jsl))
    scale = np.abs(w) @ np.abs(V[2])
    assert abs(float(pdf.df_dot(wh, wl, vh, vl)) - float(jdf.df_dot(jwh, jwl, jvh, jvl))) \
        <= RTOL * scale
    np.testing.assert_allclose(float(pdf.df_norm(wh, wl)), float(jdf.df_norm(jwh, jwl)),
                               rtol=RTOL)


def test_df_gram_comb_update_match_jax(pair_basis):
    V, w, ((Vh, Vl), (jVh, jVl)), ((wh, wl), (jwh, jwl)) = pair_basis
    np.testing.assert_allclose(pdf.df_gram(Vh, Vl, wh, wl).numpy(),
                               np.asarray(jdf.df_gram(jVh, jVl, jwh, jwl)),
                               rtol=RTOL, atol=RTOL * np.abs(w).max())
    assert not pdf.df_gram(Vh, Vl, wh, wl, 3)[3:].any()
    y = np.random.default_rng(4).standard_normal(M1)
    scale = np.abs(y) @ np.abs(V)
    _close(_m(*pdf.df_basis_comb(Vh, Vl, torch.from_numpy(y))),
           _m(*jdf.df_basis_comb(jVh, jVl, jnp.asarray(y))), scale)
    _close(_m(*pdf.df_update(wh, wl, Vh, Vl, torch.from_numpy(y))),
           _m(*jdf.df_update(jwh, jwl, jVh, jVl, jnp.asarray(y))), scale + np.abs(w))


def _orth_scale(V, w, h):
    """Magnitude of the terms that make w' (|w| + |h|^T |V|)."""
    return np.abs(w) + np.abs(np.asarray(h)) @ np.abs(V)


def test_df_cgs_matches_jax(pair_basis):
    V, w, ((Vh, Vl), (jVh, jVl)), ((wh, wl), (jwh, jwl)) = pair_basis
    u, oh, ol = pdf.df_cgs(Vh, Vl, K, wh, wl)
    ju, joh, jol = jdf.df_cgs(jVh, jVl, jwh, jwl)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=RTOL, atol=RTOL)
    _close(_m(oh, ol), _m(joh, jol), _orth_scale(V, w, ju))


@pytest.mark.parametrize("k", [0, 3, K])
def test_df_mgs_matches_jax(pair_basis, k):
    V, w, ((Vh, Vl), (jVh, jVl)), ((wh, wl), (jwh, jwl)) = pair_basis
    h, oh, ol, hn = pdf.df_mgs(Vh, Vl, k, wh, wl)
    jh, joh, jol = jdf.df_mgs(jVh, jVl, k, jwh, jwl)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=RTOL)
    assert not h[k + 1:].any()
    _close(_m(oh, ol), _m(joh, jol), _orth_scale(V, w, jh))
    np.testing.assert_allclose(float(hn), float(jdf.df_norm(joh, jol)), rtol=RTOL)


@pytest.mark.parametrize("k", [0, 3, K])
def test_df_mgs_lowsync_step_matches_jax(k):
    # unit rows with couplings of ~1/sqrt(N), so that L means something
    rng = np.random.default_rng(7)
    V = np.zeros((M1, N))
    rows = rng.standard_normal((k + 1, N))
    V[:k + 1] = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    w = rng.standard_normal(N)
    L = np.tril(V @ V.T, k=-1)
    L[k:] = 0.0
    (Vh, Vl), (jVh, jVl) = _pair(V)
    (wh, wl), (jwh, jwl) = _pair(w)
    h, oh, ol, ss, L2 = pdf.df_mgs_lowsync_step(Vh, Vl, k, wh, wl, torch.from_numpy(L.copy()))
    jh, (joh, jol), (jsh, jsl), jL = jdf.df_mgs_lowsync_step(jVh, jVl, k, jwh, jwl,
                                                            jnp.asarray(L), None)
    assert L2.dtype == torch.float64 and not h[k + 1:].any()
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(L2.numpy(), np.asarray(jL), rtol=RTOL, atol=RTOL)
    _close(_m(oh, ol), _m(joh, jol), _orth_scale(V, w, jh))
    np.testing.assert_allclose(float(ss), float(jk.merge_f64(jsh, jsl)), rtol=RTOL)


@pytest.mark.parametrize("kind,steps", [("cgs", 2), ("cgsr", 2), ("cgsr", 3), ("mgs", 2)])
def test_df_orthonormalize_step_matches_jax(pair_basis, kind, steps):
    V, w, ((Vh, Vl), (jVh, jVl)), ((wh, wl), (jwh, jwl)) = pair_basis
    h, oh, ol, hn = pdf.df_orthonormalize_step(kind, Vh, Vl, K, wh, wl, steps)
    jh, (joh, jol), jhn = jdf.df_orthonormalize_step(kind, jVh, jVl, K, jwh, jwl, None, steps)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=RTOL)
    _close(_m(oh, ol), _m(joh, jol), _orth_scale(V, w, jh))
    np.testing.assert_allclose(float(hn), float(jhn), rtol=RTOL)
    # w' is orthogonal to the live rows
    assert np.abs(V[:K + 1] @ _m(oh, ol)).max() < 1e-13 * float(hn)


def test_spmv_df64_pair_matches_jax():
    A, D, P = _jax_df64_dia(15)
    x = np.random.default_rng(5).standard_normal(A.n_rows)
    (xh, xl), (jxh, jxl) = _pair(x)
    # DF64Dia: K8's plain version against the jnp shifted-band pair path
    got = pdf.spmv_df64_pair(P, xh, xl)
    want = jdf.spmv_df64_pair(D, jxh, jxl)
    assert all(np.array_equal(g.numpy(), np.asarray(w_)) for g, w_ in zip(got, want))
    # an fp64 CSR operator: merge, the fp64 SpMV, split
    Ac = jax_convdiff(15, beta=3.0)
    Pc = csr_from_numpy(np.asarray(Ac.row_ptr), np.asarray(Ac.col_idx), np.asarray(Ac.vals),
                        n_cols=Ac.n_cols)
    got = pdf.spmv_df64_pair(Pc, xh, xl)
    want = jdf.spmv_df64_pair(Ac, jxh, jxl)
    np.testing.assert_allclose(_m(*got), _m(*want), rtol=0, atol=1e-15 * np.abs(_m(*want)).max())


@pytest.mark.parametrize("prec", ["identity", "float32", "float64"])
def test_typesafe_apply_df64_matches_jax(prec):
    from gmres_tpu.precond.build import IdentityPrec as JaxIdentity
    from gmres_tpu.precond.build import JacobiPrec as JaxJacobi

    rng = np.random.default_rng(6)
    w = rng.standard_normal(500)
    (wh, wl), (jwh, jwl) = _pair(w)
    if prec == "identity":
        M, jM = IdentityPrec(), JaxIdentity()
    else:
        d = (1.0 / (2.0 + rng.random(500))).astype(prec)
        M, jM = jacobi_from_numpy(d), JaxJacobi(inv_diag=jnp.asarray(d))
    got = pdf.typesafe_apply_df64(M, wh, wl)
    want = jdf.typesafe_apply_df64(jM, jwh, jwl)
    assert all(np.array_equal(g.numpy(), np.asarray(w_)) for g, w_ in zip(got, want))


def test_df64_staging_is_the_same_on_both_devices():
    """A decision, not an inheritance: the JAX package splits the inner
    operator only on the TPU and keeps it fp64 on its CPU branch; the port
    splits a DIA operator on both devices (K8 on the card, its plain version
    here), with the outer operator the fp64 DIAMatrix, and keeps SELL and CSR
    in fp64 for both roles."""
    cfg = gmres_tpu_torch.GmresConfig(precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64"),
                                      orth="cgsr", precond="identity")
    A_out, A_in = prepare_operators(convection_diffusion_2d(12), cfg, torch.device("cpu"))
    assert isinstance(A_in, DF64Dia) and isinstance(A_out, DIAMatrix)
    assert A_out.dtype == torch.float64
    A_out, A_in = prepare_operators(unstructured_mesh(2048, run=3, seed=6), cfg,
                                    torch.device("cpu"))
    assert isinstance(A_in, SELLMatrix) and A_in is A_out and A_in.dtype == torch.float64


# --- whole solves -----------------------------------------------------------

def _problem(A):
    x_true = rand_vect(A.n_rows, 42)
    return x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


def _port_dia(A):
    dia = jax_from_csr(A)
    return dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.n_rows, dia.n_cols, dia.nnz)


def _dense(A):
    rp = np.asarray(A.row_ptr).astype(np.int64)
    rows = np.repeat(np.arange(A.n_rows), np.diff(rp))
    dense = np.zeros((A.n_rows, A.n_cols))
    np.add.at(dense, (rows, np.asarray(A.col_idx)[: A.nnz]), np.asarray(A.vals)[: A.nnz])
    return dense


def _cfgs(mode, **kw):
    return (gmres_tpu.GmresConfig(precision=gmres_tpu.PrecisionSpec.from_mode(mode), **kw),
            gmres_tpu_torch.GmresConfig(precision=gmres_tpu_torch.PrecisionSpec.from_mode(mode),
                                        **kw))


@pytest.mark.parametrize("orth,low_sync", [("cgs", None), ("cgsr", None), ("mgs", False),
                                           ("mgs", True)],
                         ids=["cgs", "cgsr", "mgs-sequential", "mgs-icwy"])
def test_df64_solve_matches_jax_baseline_and_oracle(orth, low_sync):
    A = jax_convdiff(24, beta=1.0)
    x_true, b = _problem(A)
    kw = dict(orth=orth, precond="jacobi", restart_length=20, tol=1e-12, max_restarts=200,
              low_sync_mgs=low_sync)
    cj, cp = _cfgs("df64", **kw)
    res_jax = gmres_tpu.solve(jax_convdiff(24, beta=1.0), b, cj)
    res = gmres_tpu_torch.solve(_port_dia(A), b, cp, device="cpu")
    base = gmres_tpu_torch.solve(_port_dia(A), b, _cfgs("baseline", **kw)[1], device="cpu")
    assert res.converged and res_jax.converged and base.converged
    assert (res.restarts, res.total_iters) == (res_jax.restarts, res_jax.total_iters)
    assert (res.restarts, res.total_iters) == (base.restarts, base.total_iters)
    xj = np.asarray(res_jax.x)
    assert np.linalg.norm(res.x.numpy() - xj) / np.linalg.norm(xj) <= 1e-10
    # the dense oracle: the fp64 solver with an fp32 Jacobi preconditioner
    inv_diag = (1.0 / np.diag(_dense(A))).astype(np.float32)
    ref = oracle_solve(_dense(A), b, tol=1e-12, rlen=20, max_restarts=200,
                       orth=orth, mode="single-prec", inv_diag=inv_diag)
    assert ref.converged and (res.restarts, res.total_iters) == (ref.restarts, ref.total_iters)
    assert np.linalg.norm(res.x.numpy() - x_true) <= 10 * np.linalg.norm(base.x.numpy() - x_true) \
        + 1e-12


def test_df64_beats_mixed_in_fp32_floor_regime():
    # tests/test_df64_mode.py:72-91: at a tolerance one fp32 inner cycle
    # cannot deliver, mixed takes a second restart; df64 takes one, as the
    # baseline does
    A = jax_convdiff(24, beta=1.0)
    x_true, b = _problem(A)
    kw = dict(orth="cgsr", precond="identity", restart_length=150, tol=3e-9, max_restarts=100)
    res = {mode: gmres_tpu_torch.solve(_port_dia(A), b, _cfgs(mode, **kw)[1], device="cpu")
           for mode in ("baseline", "mixed", "df64")}
    assert res["baseline"].restarts == 1 and res["mixed"].restarts == 2
    assert res["df64"].restarts == 1
    assert res["df64"].total_iters == res["baseline"].total_iters
    assert np.linalg.norm(res["df64"].x.numpy() - x_true) < 1e-10


@pytest.mark.parametrize("kw", [dict(policy="relres", restart_improvement=1e-2),
                                dict(policy="orthloss", restart_improvement=1e-4)],
                         ids=["relres", "orthloss"])
def test_df64_policies_match_jax(kw):
    # tests/test_df64_mode.py:108-122: the policies run on the df64 cycle too
    A = jax_convdiff(16, beta=1.0)
    x_true, b = _problem(A)
    cj, cp = _cfgs("df64", orth="cgsr", precond="jacobi", restart_length=25, tol=1e-10,
                   max_restarts=200, **kw)
    res_jax = gmres_tpu.solve(jax_convdiff(16, beta=1.0), b, cj, record_history=True)
    res = gmres_tpu_torch.solve(_port_dia(A), b, cp, device="cpu", record_history=True)
    assert res.converged and res_jax.converged
    assert [h["k"] for h in res.history] == [h["k"] for h in res_jax.history]
    assert np.linalg.norm(res.x.numpy() - x_true) < 1e-6


def test_df64_with_ilu_jacobi_on_sell():
    # tests/test_df64_mode.py:94-105: the unstructured route, where the
    # inner operator is the fp64 SELL matrix (merge, K5 fp64, split)
    A = unstructured_mesh(2048, run=3, seed=6)
    x_true = gmres_tpu_torch.rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64"), orth="cgsr",
        precond="ilu_jacobi", jacobi_steps=3, restart_length=15, tol=1e-11, max_restarts=100)
    assert isinstance(gmres_tpu_torch.stage(A, cfg, device="cpu"), SELLMatrix)
    r = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    assert r.converged
    assert np.linalg.norm(r.x.numpy() - x_true) < 1e-7


def test_df64_solve_runs_k8_k9_k11_plain_versions(monkeypatch):
    # on the CPU the df64 cycle on DIA goes through the plain versions of
    # K8, K9 and K11 (and K10 for CGSR), and never through the fp32/fp64
    # basis sweeps
    from gmres_tpu_torch.ops.cuda import orth_kernel

    calls = {}
    for mod, name in ((ds, "dia_spmv_df64_plain"), (dk, "df_gram_plain"),
                      (dk, "df_update_gram_plain"), (dk, "df_update_sumsq_plain"),
                      (orth_kernel, "gram_plain"), (orth_kernel, "update_sumsq_plain")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name: calls.update(
            {_n: calls.get(_n, 0) + 1}) or _fn(*a))
    monkeypatch.setattr("gmres_tpu_torch.ops.dia.dia_spmv_df64_plain", ds.dia_spmv_df64_plain)
    A = convection_diffusion_2d(10)
    _, cp = _cfgs("df64", orth="cgsr", precond="identity", restart_length=10, tol=1e-10,
                  max_restarts=50)
    res = gmres_tpu_torch.solve(A, A.to_scipy() @ np.ones(A.n_rows), cp, device="cpu")
    assert res.converged
    steps = res.total_iters
    assert calls["dia_spmv_df64_plain"] == steps
    assert calls["df_update_gram_plain"] == calls["df_update_sumsq_plain"] == steps
    # K9: one gram a step, one in each K10, and beta's norm once a cycle,
    # the final converged check included
    assert calls["df_gram_plain"] == 2 * steps + res.restarts + 1
    assert "gram_plain" not in calls and "update_sumsq_plain" not in calls


def test_lowsync_mgs_rule_of_df64_cycles():
    # None: sequential on the CPU (the JAX package's CPU branch), ICWY on a
    # CUDA device (measured on the H100, PERF.md); native cycles keep their
    # own rule
    from gmres_tpu_torch.config import LOWSYNC_MGS_DF64_DEFAULT, use_lowsync_mgs

    cfg = gmres_tpu_torch.GmresConfig(
        precision=gmres_tpu_torch.PrecisionSpec.from_mode("df64"), orth="mgs")
    assert set(LOWSYNC_MGS_DF64_DEFAULT) == {"cpu", "cuda"}
    assert use_lowsync_mgs(cfg, "cpu") is False and use_lowsync_mgs(cfg, "cuda") is True
    assert use_lowsync_mgs(cfg.with_(low_sync_mgs=False), "cuda") is False
    native = cfg.with_(precision=gmres_tpu_torch.PrecisionSpec.from_mode("baseline"))
    assert use_lowsync_mgs(native, "cuda") is False
    A = convection_diffusion_2d(12)
    b = A.to_scipy() @ np.ones(A.n_rows)
    cfg = cfg.with_(precond="identity", restart_length=10, tol=1e-10, max_restarts=50)
    auto = gmres_tpu_torch.solve(A, b, cfg, device="cpu")
    seq = gmres_tpu_torch.solve(A, b, cfg.with_(low_sync_mgs=False), device="cpu")
    assert auto.converged and torch.equal(auto.x, seq.x)
