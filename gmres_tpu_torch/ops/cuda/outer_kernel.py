"""The fp64 outer phase of a restart cycle: the true residual with its two
norms (K1 in residual mode) and the solution update (K4), each beside its
plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/df64_kernel.py``'s ``residual_df64`` and
``axpy_df64``.  On the TPU these carried every fp64 value as a double-float
pair of fp32s (hi + lo, about 2^-48 relative), because the TPU has no fp64
units and XLA emulates fp64 in software.  The H100 has fp64 units, so the
pair disappears: x, b and r are plain fp64 tensors and the kernels compute
in native fp64.  That is also what the JAX package computes on the CPU, so
the port's outer phase matches the reference's CPU branch.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.cuda._build import check, kernel_dtype, library
from gmres_tpu_torch.ops.cuda.spmv_kernel import dia_residual_cuda, dia_residual_plain
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.ops.spmv import spmv


def outer_residual(A, b: torch.Tensor, x: torch.Tensor, inner_dtype: torch.dtype):
    """(r, ||r'||^2, ||x||^2) for r = b - A x in the outer dtype, r' = r
    rounded to the inner dtype (sums as fp64 0-d tensors).  A DIA operator
    on the card takes K1's residual mode; otherwise the plain version."""
    if isinstance(A, DIAMatrix):
        fn = dia_residual_cuda if A.data.is_cuda else dia_residual_plain
        return fn(A.data, A.offsets, b, x, inner_dtype)
    r = b - spmv(A, x)
    ri = r.to(inner_dtype)
    return r, torch.dot(ri, ri).to(torch.float64), torch.dot(x, x).to(torch.float64)


def basis_axpy_plain(x: torch.Tensor, V: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x += (y @ V[:len(y)]) promoted to x's dtype, in place; returns x."""
    rows = y.shape[0]
    x += torch.mv(V[:rows].t(), y).to(x.dtype)
    return x


def basis_axpy_cuda(x: torch.Tensor, V: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K4: x += sum_j y[j] V[j], summed in the basis dtype and added to x
    (fp64, or fp32 under uniform fp32) in place; the increment is never
    written to memory."""
    name = f"gmres_basis_axpy_{kernel_dtype('V', V)}_{kernel_dtype('x', x)}"
    if name not in ("gmres_basis_axpy_f32_f64", "gmres_basis_axpy_f64_f64",
                    "gmres_basis_axpy_f32_f32"):
        raise TypeError(f"basis_axpy: basis {V.dtype} into iterate {x.dtype}")
    rows = y.shape[0]
    if V.dim() != 2 or not 1 <= rows <= V.shape[0]:
        raise ValueError(f"basis_axpy: {rows} coefficients for V of shape {tuple(V.shape)}")
    n = V.shape[1]
    check("V", V, V.dtype, tuple(V.shape), V.device)
    check("y", y, V.dtype, (rows,), V.device)
    check("x", x, x.dtype, (n,), V.device)
    lib = library()
    if rows > lib.max_rows:
        raise ValueError(f"basis_axpy: {rows} basis rows > {lib.max_rows}")
    lib.call(name, V.data_ptr(), y.data_ptr(), x.data_ptr(), n, rows)
    basis_axpy_cuda.launches += 1
    return x


basis_axpy_cuda.launches = 0


def basis_axpy(x, V, y):
    """The solution update x += V[:len(y)]^T y, in place."""
    return basis_axpy_cuda(x, V, y) if V.is_cuda else basis_axpy_plain(x, V, y)
