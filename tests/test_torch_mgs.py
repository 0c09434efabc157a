"""The port's MGS sweeps (the plain versions of kernels K7, K2x2 and K3's
plain mode, on the CPU) against the JAX package: ``_mgs``, ``_gram2`` and
``_update`` in interpret mode, the rolled ``ops.orth.mgs`` on an fp64 basis,
and the ICWY step ``mgs_lowsync_step`` (its einsum path) in fp32 and fp64;
with a stand-in two-rank sum, that the ICWY step sums K2x2's (u, l) in one
collective with the bits of summing ``torch.stack([u, l])``.

Shapes: an (m+1, n) = (15, 32768) basis whose first 6 rows are orthonormal
and the rest zero (the Arnoldi invariant).  The JAX kernels sweep all 15
rows; the port is run both over the 6 live rows (what the solver passes at
step k = 5) and over all 15.  Tolerances: fp32, 1e-5 of the largest
magnitude of each output, because the fp32 sums over n run in another
order; fp64, 1e-12 of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.ops import orth as jax_orth
from gmres_tpu.ops.pallas.orth_kernel import _gram2, _mgs, _update
from gmres_tpu_torch.ops.cuda.mgs_kernel import mgs_plain
from gmres_tpu_torch.ops.cuda.orth_kernel import (gram2_plain, gram_plain, update_plain,
                                                  update_sumsq_plain)
from gmres_tpu_torch.ops.orth import mgs, mgs_lowsync_step, orthogonalize, orthonormalize_step

M1, N, LIVE = 15, 32768, 6
ROWS = pytest.mark.parametrize("rows", [LIVE, M1])
RTOL = {np.float32: 1e-5, np.float64: 1e-12}


def _basis(dtype=np.float32, seed=12):
    rng = np.random.default_rng(seed)
    V = np.zeros((M1, N), dtype)
    V[:LIVE] = np.linalg.qr(rng.standard_normal((N, LIVE)))[0].T.astype(dtype)
    w = rng.standard_normal(N).astype(dtype)
    u = np.zeros(M1, dtype)
    u[:LIVE] = rng.standard_normal(LIVE).astype(dtype)
    return V, w, u


@pytest.fixture(scope="module")
def basis():
    return _basis()


def _close(got, want, dtype=np.float32):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL[dtype] * max(np.abs(want).max(), 1e-30))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@ROWS
def test_mgs_plain_matches_pallas_mgs(basis, rows):
    V, w, _ = basis
    h, w2, hn = mgs_plain(*_t(V, w), rows)
    jh, jw2, jhn = _mgs(jnp.asarray(V), jnp.asarray(w), interpret=True)
    assert h.shape == (M1,) and not h[rows:].any()
    _close(h.numpy(), jh)
    _close(w2.numpy(), jw2)
    _close(float(hn), float(jhn))
    # w' is orthogonal to the live rows
    assert np.abs(V[:LIVE] @ w2.numpy()).max() < 1e-5 * float(hn)


@ROWS
def test_gram2_plain_matches_pallas_gram2(basis, rows):
    V, w, _ = basis
    w1 = V[LIVE - 1].copy()
    u0, u1 = gram2_plain(*_t(V, w, w1), rows).unbind(1)
    j0, j1 = _gram2(jnp.asarray(V), jnp.asarray(w), jnp.asarray(w1), interpret=True)
    _close(u0.numpy(), j0)
    _close(u1.numpy(), j1)


@ROWS
def test_update_plain_matches_pallas_update(basis, rows):
    V, w, u = basis
    _close(update_plain(*_t(V, w, u), rows).numpy(),
           _update(jnp.asarray(V), jnp.asarray(w), jnp.asarray(u), interpret=True))


@pytest.mark.parametrize("k", [0, LIVE - 1, M1 - 1])
def test_fp64_mgs_matches_rolled_jax_mgs(k):
    V, w, _ = _basis(np.float64, seed=3)
    jh, jw = jax_orth.mgs(jnp.asarray(V), k, jnp.asarray(w))
    h, w2, hn = mgs(*_t(V), k, torch.from_numpy(w))
    _close(h.numpy(), jh, np.float64)
    _close(w2.numpy(), jw, np.float64)
    _close(float(hn), float(np.linalg.norm(np.asarray(jw))), np.float64)
    # the orthogonalize / orthonormalize_step surfaces agree with mgs
    h_o, w_o = orthogonalize("mgs", torch.from_numpy(V), k, torch.from_numpy(w))
    assert torch.equal(h_o, h) and torch.equal(w_o, w2)
    assert all(torch.equal(a, b) for a, b in zip(
        orthonormalize_step("mgs", torch.from_numpy(V), k, torch.from_numpy(w)), (h, w2, hn)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [0, 3, LIVE - 1])
def test_lowsync_step_matches_jax(dtype, k):
    # unit rows with couplings of ~1/sqrt(N), not rounding noise, so that
    # L and the correction (I + L)^-1 u mean something
    rng = np.random.default_rng(7)
    V = np.zeros((M1, N), dtype)
    rows = rng.standard_normal((k + 1, N))
    V[: k + 1] = (rows / np.linalg.norm(rows, axis=1, keepdims=True)).astype(dtype)
    w = rng.standard_normal(N).astype(dtype)
    L = np.tril(V @ V.T, k=-1).astype(dtype)
    L[k:] = 0.0
    jh, jw, jss, jL = jax_orth.mgs_lowsync_step(jnp.asarray(V), k, jnp.asarray(w),
                                                jnp.asarray(L), None)
    h, w2, ss, L2 = mgs_lowsync_step(*_t(V), k, torch.from_numpy(w), torch.from_numpy(L.copy()))
    assert L2.dtype == torch.from_numpy(V).dtype
    _close(h.numpy(), jh, dtype)
    _close(w2.numpy(), jw, dtype)
    _close(float(ss), float(jss), dtype)
    _close(L2.numpy(), jL, dtype)
    assert not h[k + 1:].any()


class _TwoRankSum:
    """A stand-in for ``parallel.comm.Comm``: each sum adds a second rank's
    partials (drawn from a seed, one draw a call, in the tensor's shape and
    dtype) and records the shape it summed."""

    def __init__(self, seed=5):
        self.rng = np.random.default_rng(seed)
        self.shapes = []

    def all_reduce_sum(self, t):
        self.shapes.append(tuple(t.shape))
        return t + torch.from_numpy(self.rng.standard_normal(tuple(t.shape))).to(t.dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_icwy_step_sums_u_and_l_in_one_collective(dtype):
    # distributed ICWY: K2x2's (m+1, 2) output goes to the collective as it
    # is; h, w', ||w'||^2 and L are the bits of summing torch.stack([u, l])
    k = LIVE - 1
    V, w, _ = _basis(dtype, seed=3)
    L = np.tril(V @ V.T, k=-1).astype(dtype)
    L[k:] = 0.0
    comm = _TwoRankSum()
    got = mgs_lowsync_step(*_t(V), k, torch.from_numpy(w), torch.from_numpy(L.copy()), comm)
    assert comm.shapes == [(M1, 2), ()]

    old = _TwoRankSum()
    Vt, wt, Lt = *_t(V, w), torch.from_numpy(L.copy())
    u, ell = gram_plain(Vt, wt, k + 1), gram_plain(Vt, Vt[k], k + 1)
    assert torch.equal(gram2_plain(Vt, wt, Vt[k], k + 1), torch.stack([u, ell], dim=1))
    u, ell = old.all_reduce_sum(torch.stack([u, ell], dim=1)).unbind(1)
    Lt[k, :k] = ell[:k]
    h = torch.linalg.solve_triangular(Lt, u.unsqueeze(1), upper=False,
                                      unitriangular=True).squeeze(1)
    w2, ss = update_sumsq_plain(Vt, wt, h, k + 1)
    want = (h, w2, old.all_reduce_sum(ss), Lt)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
