"""The port's native-fp64 outer phase (the plain versions of K1's residual
mode and of K4 on the CPU) against the JAX package's double-float Pallas
kernels in interpret mode, ``residual_df64`` and ``axpy_df64``, their (hi, lo)
results merged to fp64.

Double-float carries about 2^-48 relative precision against fp64's 2^-53,
so the residual is held to 1e-12 of max|b| and the update to 1e-13 of
max|x|.  The sums of squares the TPU kernel takes in fp32 are held to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.io.rng import rand_vect
from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.ops.pallas.df64_kernel import (
    _halo_pad,
    axpy_df64,
    merge_f64,
    residual_df64,
    split_f64,
)
from gmres_tpu_torch.convert import dia_from_numpy
from gmres_tpu_torch.ops.cuda.outer_kernel import basis_axpy, outer_residual


def test_residual_matches_double_float_kernel():
    dia = jax_from_csr(jax_convdiff(64, beta=2.0))
    n = dia.n_rows
    x = rand_vect(n, 42)
    b = np.random.default_rng(5).standard_normal(n)

    pad = _halo_pad(dia.offsets)
    dh, dl = split_f64(jnp.asarray(dia.data))
    bh, bl = split_f64(jnp.asarray(b))
    xh, xl = split_f64(jnp.asarray(x))
    rh, rl, r_ss, x_ss = residual_df64(dh, dl, bh, bl, jnp.pad(xh, pad), jnp.pad(xl, pad),
                                       dia.offsets, interpret=True)
    want = np.asarray(merge_f64(rh, rl))

    port = dia_from_numpy(np.asarray(dia.data), dia.offsets, n, dia.n_cols, dia.nnz)
    r, rss, xss = outer_residual(port, torch.from_numpy(b), torch.from_numpy(x),
                                 torch.float32)
    assert r.dtype == torch.float64
    np.testing.assert_allclose(r.numpy(), want, rtol=0, atol=1e-12 * np.abs(b).max())
    # ||fp32(r)||^2 and ||x||^2: the TPU kernel sums fp32 squares of the hi
    # parts, the port fp32(r)^2 in fp32 and x^2 in fp64
    np.testing.assert_allclose(float(rss), float(r_ss), rtol=1e-5)
    np.testing.assert_allclose(float(xss), float(x_ss), rtol=1e-5)


@pytest.mark.parametrize("rows", [1, 30])
def test_basis_axpy_matches_double_float_update(rows):
    rng = np.random.default_rng(9)
    n = 4096
    x = rand_vect(n, 3)
    V = (rng.standard_normal((31, n)) / np.sqrt(n)).astype(np.float32)
    y = rng.standard_normal(rows).astype(np.float32)
    # the fp32 increment the solver adds: the basis combination in fp32
    inc = torch.mv(torch.from_numpy(V[:rows]).t(), torch.from_numpy(y)).numpy()
    oh, ol = axpy_df64(*split_f64(jnp.asarray(x)), jnp.asarray(inc), interpret=True)
    want = np.asarray(merge_f64(oh, ol))

    xt = torch.from_numpy(x.copy())
    got = basis_axpy(xt, torch.from_numpy(V), torch.from_numpy(y))
    assert got is xt  # updated in place
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13 * np.abs(x).max())
