"""The compressed basis (``PrecisionSpec.basis``) on the CPU: the plain
versions of the dtype forms of K2, K2x2, K3 (three modes), K7 and K4 against
the JAX package's functions, and whole compressed-basis solves against
``gmres_tpu.solve`` and the dense oracle (``tests/oracle_gmres.py``).

Kernels at n = 32,768 (the Pallas block), a 15-row basis whose first 6 rows
are live:
- (bf16 basis, fp32 vectors): the Pallas kernels in interpret mode
  (``_gram``, ``_gram2``, ``_update``, ``_update_gram``, ``_update_sumsq``,
  ``_mgs``), as ``tests/test_cb_basis.py`` runs them.  Both sides sum the
  bf16 values widened to fp32 in fp32, in another order: outputs held to
  1e-5 of their largest magnitude.
- (fp32 basis, fp64 vectors): no Pallas kernel takes fp64; the JAX
  package's XLA route (``gmres_tpu.ops.orth``) sums in fp64: 1e-13.
- K4 against the XLA formula of ``gmres_tpu/solver/gmres.py:546-550``
  (``x + jnp.matmul(y, V, precision=HIGHEST).astype(x.dtype)``): 1e-6 of
  the sum of the terms' magnitudes for an fp32 increment, 1e-13 for fp64,
  and for a bf16 increment (rounded to bf16 before the add) one bf16 ulp,
  2^-7 of it.

Solves (``convection_diffusion_2d(16)`` and ``(24)``, Jacobi, restart 20,
tol 1e-9, as ``tests/test_cb_basis.py``): mixed with a bf16 basis and
baseline with an fp32 one, CGSR, CGS, sequential MGS and ICWY; the
restarts agree with ``gmres_tpu.solve``'s within one (the JAX test's slack
against the uncompressed solve), x within 1e-5 (bf16 basis: the two fp32
cycles round differently and stop at the tolerance at another point) or
1e-10 (fp32 basis under fp64) relative to ``gmres_tpu``'s.  The two mixed-cb rows of
``tests/test_golden_oracle.py``'s TIER_CASES are pinned to the oracle with
a bf16 basis and that test's slack.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import gmres_tpu
import gmres_tpu_torch
from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.ops import orth as jorth
from gmres_tpu.ops.pallas import orth_kernel as jk
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu.sparse import csr_from_arrays as jax_csr_from_arrays
from gmres_tpu_torch.convert import csr_from_numpy as _csr_from_numpy
from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
from gmres_tpu_torch.ops.cuda import orth_kernel as ok
from gmres_tpu_torch.ops.cuda import outer_kernel as ou

from oracle_gmres import oracle_solve


def csr_from_numpy(A):
    """The port's CSR matrix of a JAX CSR matrix."""
    return _csr_from_numpy(A.row_ptr, A.col_idx, A.vals, n_cols=A.n_cols)

M1, N, LIVE = 15, 32 * 1024, 6


@pytest.fixture(scope="module")
def basis():
    rng = np.random.default_rng(9)
    V = np.zeros((M1, N), np.float32)
    V[:LIVE] = np.linalg.qr(rng.standard_normal((N, LIVE)))[0].T
    w = rng.standard_normal(N)
    u = np.zeros(M1)
    u[:LIVE] = rng.standard_normal(LIVE)
    return V, w, u


def _close(got, want, rel, scale=None):
    got = np.asarray(torch.as_tensor(got).double() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    scale = np.abs(want) if scale is None else np.abs(np.asarray(scale, np.float64))
    assert np.abs(got - want).max() <= rel * max(scale.max(), 1e-300)


def _bf16_f32(V, w, u):
    """The (bf16 basis, fp32 vectors) inputs: torch tensors and jax arrays."""
    Vt = torch.from_numpy(V).to(torch.bfloat16)
    wt = torch.from_numpy(w.astype(np.float32))
    ut = torch.from_numpy(u.astype(np.float32))
    return (Vt, wt, ut), (jnp.asarray(V, jnp.bfloat16), jnp.asarray(wt.numpy()),
                          jnp.asarray(ut.numpy()))


@pytest.mark.parametrize("rows", [LIVE, M1])
def test_bf16_f32_sweeps_match_the_pallas_kernels(basis, rows):
    (V, w, u), (jV, jw, ju) = _bf16_f32(*basis)
    got = ok.gram(V, w, rows)
    assert got.dtype == torch.float32
    _close(got, jk._gram(jV, jw, interpret=True), 1e-5)
    got = ok.update(V, w, u, rows)
    assert got.dtype == torch.float32
    _close(got, jk._update(jV, jw, ju, interpret=True), 1e-5)
    w1, u2 = ok.update_gram(V, w, u, rows)
    jw1, ju2 = jk._update_gram(jV, jw, ju, interpret=True)
    assert w1.dtype == u2.dtype == torch.float32
    _close(w1, jw1, 1e-5)
    _close(u2, ju2, 1e-5)
    w2, ss = ok.update_sumsq(V, w, u, rows)
    jw2, jss = jk._update_sumsq(jV, jw, ju, interpret=True)
    assert w2.dtype == ss.dtype == torch.float32
    _close(w2, jw2, 1e-5)
    _close(float(ss), float(jss), 1e-5)
    vk = V[rows - 1].float()
    for g, j in zip(ok.gram2(V, w, vk, rows).unbind(1),
                    jk._gram2(jV, jw, jnp.asarray(vk.numpy()), interpret=True)):
        assert g.dtype == torch.float32
        _close(g, j, 1e-5)
    h, w3, hn = ok.cgsr2(V, w, rows)
    jh, jw3, jhn = jk.cgsr2_pallas(jV, jw, interpret=True)
    _close(h, jh, 1e-5)
    _close(w3, jw3, 1e-5)
    _close(float(hn), float(jhn), 1e-5)


@pytest.mark.parametrize("rows", [LIVE, M1])
def test_bf16_f32_mgs_matches_the_pallas_kernel(basis, rows):
    (V, w, _), (jV, jw, _) = _bf16_f32(*basis)
    h, w2, hn = mk.mgs(V, w, rows)
    jh, jw2, jhn = jk._mgs(jV, jw, interpret=True)
    assert h.dtype == w2.dtype == hn.dtype == torch.float32
    _close(h, jh, 1e-5)
    _close(w2, jw2, 1e-5)
    _close(float(hn), float(jhn), 1e-5)


@pytest.mark.parametrize("rows", [LIVE, M1])
def test_f32_f64_sweeps_match_the_xla_route(basis, rows):
    V, w, u = basis
    Vt, wt, ut = torch.from_numpy(V), torch.from_numpy(w), torch.from_numpy(u)
    jV, jw, ju = jnp.asarray(V), jnp.asarray(w), jnp.asarray(u)
    k = rows - 1
    scale = np.abs(V[:rows]).astype(np.float64).T @ np.abs(u[:rows]) + np.abs(w)
    got = ok.gram(Vt, wt, rows)
    assert got.dtype == torch.float64
    _close(got, jorth._masked_gram(jV, jw, k, None), 1e-13,
           np.abs(V).astype(np.float64) @ np.abs(w))
    ju_k = jnp.where(jnp.arange(M1) <= k, ju, 0)
    want = jw - jnp.sum(ju_k[:, None] * jV.astype(jnp.float64), axis=0)  # cgs's update
    _close(ok.update(Vt, wt, ut, rows), want, 1e-13, scale)
    w1, u2 = ok.update_gram(Vt, wt, ut, rows)
    _close(w1, want, 1e-13, scale)
    _close(u2, jorth._masked_gram(jV, jnp.asarray(w1.numpy()), k, None), 1e-13,
           np.abs(V).astype(np.float64) @ scale)
    w2, ss = ok.update_sumsq(Vt, wt, ut, rows)
    assert ss.dtype == torch.float64
    _close(float(ss), float(jnp.dot(want, want)), 1e-13, scale @ scale)
    jh, jw3 = jorth.mgs(jV, k, jw)
    h, w3, hn = mk.mgs(Vt, wt, rows)
    _close(h, jh, 1e-13, np.abs(V).astype(np.float64) @ np.abs(w))
    _close(w3, jw3, 1e-13, np.abs(w) + np.abs(V).T @ np.abs(np.asarray(jh)))
    vk = Vt[rows - 1].double()
    P = np.asarray(jnp.sum(jV.astype(jnp.float64)[:rows, None, :]
                           * jnp.stack([jw, jnp.asarray(vk.numpy())])[None], axis=2))
    for c, g in enumerate(ok.gram2(Vt, wt, vk, rows).unbind(1)):
        _close(g[:rows], P[:, c], 1e-13, np.abs(V[:rows]).astype(np.float64) @ (
            np.abs(w) + np.abs(vk.numpy())))


@pytest.mark.parametrize("vt,yt,xt", [("bfloat16", "float32", "float64"),
                                      ("bfloat16", "float32", "float32"),
                                      ("float32", "float64", "float64"),
                                      ("bfloat16", "bfloat16", "float64"),
                                      ("bfloat16", "bfloat16", "float32")])
def test_basis_axpy_forms_match_the_xla_update(basis, vt, yt, xt):
    V = basis[0]
    rng = np.random.default_rng(3)
    jV = jnp.asarray(V).astype(vt)
    jy = jnp.asarray(rng.standard_normal(M1 - 1)).astype(yt)
    jx = jnp.asarray(rng.random(N)).astype(xt)
    want = jx + jnp.matmul(jy, jV[:M1 - 1], precision=jax.lax.Precision.HIGHEST).astype(xt)
    # the same values on the port's side (each exact in its dtype)
    Vt, yt_, xt_ = (torch.tensor(np.asarray(a.astype(jnp.float64))).to(getattr(torch, d))
                    for a, d in ((jV, vt), (jy, yt), (jx, xt)))
    got = ou.basis_axpy(xt_, Vt, yt_)
    assert got.dtype == getattr(torch, xt)
    inc = str(jnp.promote_types(vt, yt))
    rel = {"float32": 1e-6, "float64": 1e-13, "bfloat16": 2.0 ** -7}[inc]
    scale = np.abs(np.asarray(jx, np.float64)) + np.abs(np.asarray(jy, np.float64)) @ np.abs(
        np.asarray(jV[:M1 - 1], np.float64))
    _close(got, want, max(rel, 1e-6) if xt == "float32" else rel, scale)


def test_wrappers_refuse_a_dtype_pair_without_a_form():
    # checked before any library is built or any device is asked for
    V = torch.zeros((4, 100), dtype=torch.float64)
    w = torch.zeros(100, dtype=torch.float32)
    with pytest.raises(TypeError, match="no kernel form"):
        ok.gram_cuda(V, w, 2)
    with pytest.raises(TypeError, match="no kernel form"):
        mk.mgs_cuda(V.bfloat16(), w.double(), 2)
    with pytest.raises(TypeError, match="no kernel form"):
        ok.gram2_cuda(V.bfloat16(), w.bfloat16(), w.bfloat16(), 2)
    with pytest.raises(TypeError, match="no kernel form"):
        ou.basis_axpy_cuda(w.double(), V, w[:3])  # an fp64 basis, fp32 coefficients


def _problem(nx):
    A = jax_convdiff(nx)
    x_true = rand_vect(A.n_rows, 42)
    return A, x_true, np.asarray(jax_spmv(A, jnp.asarray(x_true)))


def _cb(pkg, mode, basis):
    return dataclasses.replace(pkg.PrecisionSpec.from_mode(mode), basis=basis)


@pytest.mark.parametrize("nx", [16, 24])
@pytest.mark.parametrize("orth,low", [("cgsr", None), ("cgs", None), ("mgs", False),
                                      ("mgs", True)],
                         ids=["cgsr", "cgs", "mgs-sequential", "mgs-icwy"])
@pytest.mark.parametrize("mode,basis,x_rel", [("mixed", "bfloat16", 1e-5),
                                              ("baseline", "float32", 1e-10)],
                         ids=["mixed-cb", "baseline-cb"])
def test_compressed_basis_solve_matches_gmres_tpu(nx, orth, low, mode, basis, x_rel):
    A, x_true, b = _problem(nx)
    kw = dict(orth=orth, low_sync_mgs=low, precond="jacobi", restart_length=20, tol=1e-9,
              max_restarts=300)
    rj = gmres_tpu.solve(A, b, gmres_tpu.GmresConfig(precision=_cb(gmres_tpu, mode, basis),
                                                      **kw))
    rt = gmres_tpu_torch.solve(csr_from_numpy(A), b, gmres_tpu_torch.GmresConfig(
        precision=_cb(gmres_tpu_torch, mode, basis), **kw), device="cpu")
    assert rj.converged and rt.converged
    assert abs(rt.restarts - rj.restarts) <= 1, (rt.restarts, rj.restarts)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= x_rel * np.linalg.norm(xj)
    assert np.linalg.norm(rt.x.numpy() - x_true) < 1e-5


def _dense(A):
    rp = np.asarray(A.row_ptr).astype(np.int64)
    rows = np.repeat(np.arange(A.n_rows), np.diff(rp))
    D = np.zeros((A.n_rows, A.n_cols))
    np.add.at(D, (rows, np.asarray(A.col_idx)[:rp[-1]]), np.asarray(A.vals)[:rp[-1]])
    return D


def _unstructured(n=768, row_nnz=7, seed=11):
    """tests/test_golden_oracle.py:_unstructured."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), row_nnz)
    cols = rng.integers(0, n, size=n * row_nnz)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    _, keep = np.unique(rows.astype(np.int64) * n + cols, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.standard_normal(rows.shape[0])
    vals[rows == cols] = row_nnz + 2.0
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rp = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return jax_csr_from_arrays(rp, cols, vals, n_cols=n)


# the mixed-cb rows of tests/test_golden_oracle.py:TIER_CASES:
# (matrix, orth, policy, rtol, rlen, tol)
ORACLE_CASES = [("convdiff24", "cgsr", "fixed", 0.0, 40, 1e-8),
                ("unstruct", "cgsr", "relres", 1e-2, 30, 1e-10)]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_mixed_cb_matches_the_oracle(case):
    name, orth, policy, rtol, rlen, tol = case
    A = jax_convdiff(24, beta=1.0) if name == "convdiff24" else _unstructured()
    x_true = rand_vect(A.n_rows, 42)
    b = np.asarray(jax_spmv(A, jnp.asarray(x_true)))
    ref = oracle_solve(_dense(A), b, tol=tol, rlen=rlen, max_restarts=400, orth=orth,
                       mode="mixed", policy=policy, rtol=rtol,
                       basis_dtype=ml_dtypes.bfloat16)
    assert ref.converged
    cfg = gmres_tpu_torch.GmresConfig(
        precision=_cb(gmres_tpu_torch, "mixed", "bfloat16"), orth=orth, precond="identity",
        policy=policy, restart_improvement=rtol, restart_length=rlen, tol=tol,
        max_restarts=400)
    res = gmres_tpu_torch.solve(csr_from_numpy(A), b, cfg, device="cpu")
    assert res.converged
    # test_golden_oracle's slack for a bf16 basis
    assert abs(res.restarts - ref.restarts) <= 2, (res.restarts, ref.restarts)
    assert abs(res.total_iters - ref.total_iters) <= max(2 * rlen // 10 + 2,
                                                         0.08 * ref.total_iters)
