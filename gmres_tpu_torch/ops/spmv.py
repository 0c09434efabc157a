"""Sparse matrix-vector product dispatch.

DIA operators go to ``dia_spmv`` (kernel K1 on the card).  CSR is the
fallback for unstructured matrices: a plain torch gather plus
``index_add_`` over the precomputed row ids, as the JAX package leaves its
CSR path to XLA.  The SELL and double-float operator formats are not
ported yet.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.dia import DIAMatrix, dia_spmv
from gmres_tpu_torch.sparse import CSRMatrix


def csr_spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_{k: row_ids[k] == i} vals[k] * x[col_idx[k]]."""
    prod = A.vals * x.to(A.vals.dtype)[A.col_idx]
    y = torch.zeros(A.n_rows, dtype=A.vals.dtype, device=A.vals.device)
    return y.index_add_(0, A.row_ids, prod)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in A's dtype; x is cast to A's dtype first."""
    if isinstance(A, DIAMatrix):
        return dia_spmv(A, x)
    if isinstance(A, CSRMatrix):
        return csr_spmv(A, x)
    raise NotImplementedError(
        f"spmv on {type(A).__name__}: the port takes DIA and CSR operators; "
        "SELL packs come with slice 2 and double-float (df64) operators with "
        "slice 5")
