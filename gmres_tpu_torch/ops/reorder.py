"""Bandwidth-reducing row/column reordering, on the host.

``solve(..., reorder="rcm")`` permutes A symmetrically at setup, solves
the permuted system and un-permutes the solution; convergence is that of
the permuted system.  A reordering brings a scattered pattern's nonzeros
near the diagonal, so the DIA format may accept it and the sliced ELL's
x gathers become local.  Carried from ``gmres_tpu.ops.reorder`` and held
to the same arrays.
"""

from __future__ import annotations

import numpy as np

from gmres_tpu_torch.sparse import CSRMatrix, csr_from_coo


def rcm_permutation(A: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (on the symmetrized pattern)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = reverse_cuthill_mckee(A.to_scipy(), symmetric_mode=False)
    return np.asarray(perm, dtype=np.int64)


def _coo(A: CSRMatrix):
    rp, ci, v = A.numpy_arrays()
    rp = rp.astype(np.int64)
    nnz = int(rp[-1])
    rows = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
    return rows, ci[:nnz].astype(np.int64), v[:nnz]


def permute_symmetric(A: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """B = P A P^T with B[i, j] = A[perm[i], perm[j]]."""
    rows, ci, v = _coo(A)
    inv = np.empty(A.n_rows, dtype=np.int64)
    inv[perm] = np.arange(A.n_rows, dtype=np.int64)
    return csr_from_coo(inv[rows], inv[ci], v, n_rows=A.n_rows, n_cols=A.n_cols,
                        sum_duplicates=False)


def bandwidth(A: CSRMatrix) -> int:
    rows, ci, _ = _coo(A)
    if ci.size == 0:
        return 0
    return int(np.abs(ci - rows).max())
