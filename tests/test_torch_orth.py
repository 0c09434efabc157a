"""The port's CGSR basis sweeps (the plain versions of kernels K2/K3 on the
CPU) against the JAX package's Pallas kernels in interpret mode: ``_gram``,
``_update_gram``, ``_update_sumsq`` and their chain ``cgsr2_pallas``.

Shapes: an (m+1, n) = (31, 32768) fp32 basis whose first 7 rows are
orthonormal and the rest zero (the Arnoldi invariant).  The JAX kernels sweep
all 31 rows; the port is run both over the 7 live rows (what the solver
passes at step k = 6) and over all 31.  Tolerance: 1e-5 of the largest
magnitude of each output, because the fp32 sums over n run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.ops.pallas.orth_kernel import _gram, _update_gram, _update_sumsq, cgsr2_pallas
from gmres_tpu_torch.ops.cuda.orth_kernel import cgsr2, gram, update_gram, update_sumsq

M1, N, LIVE = 31, 32768, 7
ROWS = pytest.mark.parametrize("rows", [LIVE, M1])


@pytest.fixture(scope="module")
def basis():
    rng = np.random.default_rng(11)
    V = np.zeros((M1, N), np.float32)
    V[:LIVE] = np.linalg.qr(rng.standard_normal((N, LIVE)))[0].T.astype(np.float32)
    w = rng.standard_normal(N).astype(np.float32)
    u = np.zeros(M1, np.float32)
    u[:LIVE] = rng.standard_normal(LIVE).astype(np.float32)
    return V, w, u


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@ROWS
def test_gram(basis, rows):
    V, w, _ = basis
    got = gram(*_t(V, w), rows)
    assert got.shape == (M1,)
    _close(got.numpy(), _gram(jnp.asarray(V), jnp.asarray(w), interpret=True))


@ROWS
def test_update_gram(basis, rows):
    V, w, u = basis
    w1, u2 = update_gram(*_t(V, w, u), rows)
    jw1, ju2 = _update_gram(jnp.asarray(V), jnp.asarray(w), jnp.asarray(u), interpret=True)
    _close(w1.numpy(), jw1)
    _close(u2.numpy(), ju2)


@ROWS
def test_update_sumsq(basis, rows):
    V, w, u = basis
    w2, ss = update_sumsq(*_t(V, w, u), rows)
    jw2, jss = _update_sumsq(jnp.asarray(V), jnp.asarray(w), jnp.asarray(u), interpret=True)
    _close(w2.numpy(), jw2)
    _close(float(ss), float(jss))


@ROWS
def test_cgsr2(basis, rows):
    V, w, _ = basis
    h, w2, hn = cgsr2(*_t(V, w), rows)
    jh, jw2, jhn = cgsr2_pallas(jnp.asarray(V), jnp.asarray(w), interpret=True)
    _close(h.numpy(), jh)
    _close(w2.numpy(), jw2)
    _close(float(hn), float(jhn))
    # the live rows are orthogonal to the result; rows past `rows` stay zero
    assert np.abs(V[:LIVE] @ w2.numpy()).max() < 1e-5 * float(hn)
    assert not h[rows:].any()
