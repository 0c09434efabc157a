"""The port's DIA and CSR SpMV (the plain version of kernel K1 on the CPU)
against the JAX package: its Pallas DIA kernel in interpret mode (fp32), its
XLA DIA SpMV (fp64) and its CSR gather + segment-sum, on the same operator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmres_tpu.io.synth import convection_diffusion_2d as jax_convdiff
from gmres_tpu.ops.dia import dia_spmv as jax_dia_spmv
from gmres_tpu.ops.dia import from_csr as jax_from_csr
from gmres_tpu.ops.pallas.spmv_kernel import dia_spmv_pallas
from gmres_tpu.ops.spmv import spmv as jax_spmv
from gmres_tpu_torch.convert import csr_from_numpy, dia_from_numpy
from gmres_tpu_torch.ops.dia import dia_spmv
from gmres_tpu_torch.ops.spmv import spmv


def _pair(dtype):
    A = jax_convdiff(64, beta=2.0)
    dia = jax_from_csr(A).astype(dtype)
    port = dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.n_rows,
                          dia.n_cols, dia.nnz)
    return A, dia, port


def _x(n, dtype):
    return np.random.default_rng(7).standard_normal(n).astype(dtype)


def test_dia_spmv_f32_matches_pallas_kernel():
    # fp32: the two sum the 5 band products with different rounding (the
    # Pallas kernel's in-VMEM FMA chain vs torch's multiply-then-add), so
    # allow 1e-6 relative, with an absolute floor at 1e-6 of max|y| for
    # entries that cancel to near zero
    _, dia, port = _pair(jnp.float32)
    x = _x(dia.n_rows, np.float32)
    want = np.asarray(dia_spmv_pallas(dia, jnp.asarray(x), interpret=True))
    got = dia_spmv(port, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_dia_spmv_f64_matches_xla_path():
    # fp64: same products, summed band by band in the same order on both
    # sides; 1e-14 relative leaves room for a contracted multiply-add
    _, dia, port = _pair(jnp.float64)
    x = _x(dia.n_rows, np.float64)
    want = np.asarray(jax_dia_spmv(dia, jnp.asarray(x), use_pallas=False))
    got = dia_spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())


def test_csr_spmv_matches_gather_segment_sum():
    # the CSR fallback: per-row sums of the same products in row order
    A = jax_convdiff(24, beta=1.0)
    port = csr_from_numpy(np.asarray(A.row_ptr), np.asarray(A.col_idx),
                          np.asarray(A.vals), n_cols=A.n_cols)
    x = _x(A.n_rows, np.float64)
    want = np.asarray(jax_spmv(A, jnp.asarray(x)))
    got = spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("offsets", [(-70, 0, 3), (5, 9), (-4096, 4095)])
def test_dia_spmv_reads_zero_outside_x(offsets):
    # bands that run off either end of x (including an offset that leaves a
    # single row in range): the plain version against the dense product
    rng = np.random.default_rng(3)
    n = 4096
    data = rng.standard_normal((len(offsets), n))
    port = dia_from_numpy(data, offsets, n, n, nnz=0)
    x = rng.standard_normal(n)
    got = dia_spmv(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, port.to_dense() @ x, rtol=1e-12, atol=1e-12)
