"""Build the port's operators and preconditioners from plain numpy arrays.

These take the arrays of a ``gmres_tpu`` object, read out with
``np.asarray`` (for example ``np.asarray(A.data)`` of a DIA matrix), so that
both packages can run on one operator without this package importing the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.precond.build import JacobiPrec
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_arrays


def dia_from_numpy(data, offsets, n_rows: int, n_cols: int, nnz: int,
                   device="cpu") -> DIAMatrix:
    data = np.ascontiguousarray(np.asarray(data))
    if data.shape != (len(offsets), n_rows):
        raise ValueError(f"DIA data of shape {data.shape} for {len(offsets)} "
                         f"offsets and {n_rows} rows")
    return DIAMatrix(data=torch.from_numpy(data).to(device),
                     offsets=tuple(int(o) for o in offsets),
                     n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(nnz))


def csr_from_numpy(row_ptr, col_idx, vals, n_cols: int | None = None,
                   device="cpu") -> CSRMatrix:
    """From CSR arrays; entries past ``row_ptr[-1]`` (the JAX package's
    padding) are dropped."""
    return csr_from_arrays(np.asarray(row_ptr), np.asarray(col_idx),
                           np.asarray(vals), n_cols=n_cols).to(device)


def jacobi_from_numpy(inv_diag, device="cpu") -> JacobiPrec:
    return JacobiPrec(inv_diag=torch.from_numpy(
        np.ascontiguousarray(np.asarray(inv_diag))).to(device))
