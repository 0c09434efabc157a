"""Preconditioner construction (host, setup time).

Mirrors the reference's dispatch (``gmres_perf_test.cpp:68-92``): Jacobi
extracts a safeguarded inverse diagonal, identity is a no-op.  The ILU
family is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig, Precond
from gmres_tpu_torch.sparse import CSRMatrix

_NUMPY_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


@dataclasses.dataclass(frozen=True)
class IdentityPrec:
    def to(self, device) -> "IdentityPrec":
        return self


@dataclasses.dataclass(frozen=True)
class JacobiPrec:
    """Inverse main diagonal with the reference's pivot safeguard
    ``alpha = eps(float32) * max_i ||row_i||_1`` (``types.hpp:397-431``;
    the reference uses float eps whatever the build dtype)."""

    inv_diag: torch.Tensor

    def to(self, device) -> "JacobiPrec":
        return JacobiPrec(inv_diag=self.inv_diag.to(device))


def _diag_positions(rp: np.ndarray, ci: np.ndarray) -> np.ndarray:
    """Position of each row's diagonal entry in a row-sorted CSR whose
    every row stores its diagonal: rp[i] + #(cols < i in row i)."""
    n = rp.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    below = (ci[: rp[-1]].astype(np.int64) < row_ids).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(below)])
    return rp[:-1] + (cum[rp[1:]] - cum[rp[:-1]])


def _safeguarded_inverse(dv: np.ndarray, row_abs: np.ndarray, dtype) -> torch.Tensor:
    alpha = float(np.finfo(np.float32).eps) * float(row_abs.max(initial=0.0))
    clamped = np.where(dv >= 0, np.maximum(dv, alpha), np.minimum(dv, -alpha))
    return torch.from_numpy((1.0 / clamped).astype(dtype))


def build_jacobi(A: CSRMatrix, dtype: torch.dtype) -> JacobiPrec:
    rp, ci, vals = A.numpy_arrays()
    rp = rp.astype(np.int64)
    nnz = int(rp[-1])
    ci = ci[:nnz].astype(np.int64)
    # the reference builds Jacobi<PrecType> from a PrecType copy of A, so
    # the row norms and the diagonal come from the downcast values
    ndt = _NUMPY_DTYPE[dtype]
    v = vals[:nnz].astype(ndt).astype(np.float64)
    row_ids = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
    row_abs = np.zeros(A.n_rows)
    np.add.at(row_abs, row_ids, np.abs(v))
    dv = v[_diag_positions(rp, ci)]
    return JacobiPrec(inv_diag=_safeguarded_inverse(dv, row_abs, ndt))


def build_jacobi_from_dia(A, dtype: torch.dtype) -> JacobiPrec:
    """Jacobi from a DIA operator: the offset-0 band is the diagonal and the
    row 1-norms sum |data| down the bands."""
    ndt = _NUMPY_DTYPE[dtype]
    data = A.data.cpu().numpy().astype(np.float64).astype(ndt).astype(np.float64)
    try:
        d0 = A.offsets.index(0)
    except ValueError:
        raise ValueError("Jacobi preconditioner: DIA operator has no main diagonal")
    return JacobiPrec(inv_diag=_safeguarded_inverse(
        data[d0], np.abs(data).sum(axis=0), ndt))


def build_preconditioner(A, cfg: GmresConfig):
    """Build the preconditioner in the configured dtype from the (fp64)
    assembled matrix; the result lies on the CPU."""
    dtype = cfg.precision.precond_dtype
    if cfg.precond == Precond.IDENTITY:
        return IdentityPrec()
    if cfg.precond == Precond.JACOBI:
        if dtype not in _NUMPY_DTYPE:
            raise NotImplementedError(
                f"a {dtype} preconditioner is slice 5 of the port (bf16 tier)")
        if isinstance(A, CSRMatrix):
            return build_jacobi(A, dtype)
        if hasattr(A, "offsets"):
            return build_jacobi_from_dia(A, dtype)
        raise TypeError(f"jacobi preconditioner for {type(A).__name__}")
    if cfg.precond in (Precond.ILU, Precond.ILU_JACOBI):
        raise NotImplementedError(
            f"precond={cfg.precond.value!r} (the ILU(0) family) is slice 3 of the port")
    if cfg.precond == Precond.BILU_JACOBI:
        raise NotImplementedError(
            "precond='bilu_jacobi' is the distributed block-Jacobi ILU, slice 7 "
            "of the port")
    raise ValueError(f"unknown preconditioner {cfg.precond}")
