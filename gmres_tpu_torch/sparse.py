"""CSR sparse matrix container on torch tensors.

The builders work in numpy on the host and wrap their arrays as CPU
tensors; ``CSRMatrix.to(device)`` moves them.  Beside the CSR triplet the
container keeps ``row_ids``, the COO row index of each stored entry: the
plain CSR SpMV (``ops/spmv.py``) is a gather plus ``index_add_`` over it.

Unlike ``gmres_tpu.sparse`` the arrays are not padded to a multiple of
1024 entries; that padding only served the TPU's register tiling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """CSR matrix with precomputed COO row ids (rows sorted by column)."""

    row_ptr: torch.Tensor  # (n_rows+1,) int64
    col_idx: torch.Tensor  # (nnz,) int64
    row_ids: torch.Tensor  # (nnz,) int64, non-decreasing
    vals: torch.Tensor     # (nnz,)
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def astype(self, dtype: torch.dtype) -> "CSRMatrix":
        """Dtype-staged copy (the reference's cross-dtype SparseMatrix copy,
        ``types_cuda.hpp:116-130``)."""
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def to(self, device) -> "CSRMatrix":
        return dataclasses.replace(
            self,
            row_ptr=self.row_ptr.to(device),
            col_idx=self.col_idx.to(device),
            row_ids=self.row_ids.to(device),
            vals=self.vals.to(device),
        )

    def numpy_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(row_ptr, col_idx, vals) as host numpy arrays."""
        return (self.row_ptr.cpu().numpy(), self.col_idx.cpu().numpy(),
                self.vals.cpu().numpy())

    def to_scipy(self):
        """The matrix as a ``scipy.sparse.csr_matrix`` on the host."""
        import scipy.sparse as sp

        row_ptr, col_idx, vals = self.numpy_arrays()
        return sp.csr_matrix((vals, col_idx, row_ptr), shape=self.shape)


def csr_from_arrays(row_ptr, col_idx, vals, n_cols: int | None = None) -> CSRMatrix:
    """Build a CSRMatrix from raw CSR arrays (host numpy; ``vals`` may be a
    CPU tensor).  Entries past ``row_ptr[-1]`` are dropped."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    n_rows = row_ptr.shape[0] - 1
    n_cols = int(n_cols) if n_cols is not None else n_rows
    nnz = int(row_ptr[-1])
    col_idx = np.asarray(col_idx, dtype=np.int64)
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.ascontiguousarray(vals))
    if col_idx.shape[0] < nnz or vals.shape[0] < nnz:
        raise ValueError(
            f"row_ptr declares {nnz} entries but col_idx/vals hold "
            f"{col_idx.shape[0]}/{vals.shape[0]}")
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(row_ptr))
    return CSRMatrix(
        row_ptr=torch.from_numpy(row_ptr),
        col_idx=torch.from_numpy(np.ascontiguousarray(col_idx[:nnz])),
        row_ids=torch.from_numpy(row_ids),
        vals=vals[:nnz].contiguous(),
        n_rows=n_rows,
        n_cols=n_cols,
        nnz=nnz,
    )


def csr_from_coo(rows, cols, vals, n_rows: int, n_cols: int | None = None,
                 sum_duplicates: bool = True) -> CSRMatrix:
    """COO -> CSR with entries sorted by (row, col); duplicates summed."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    n_cols = int(n_cols) if n_cols is not None else int(n_rows)

    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]

    if sum_duplicates and rows.size:
        key_same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if key_same.any():
            group_start = np.concatenate([[True], ~key_same])
            group_id = np.cumsum(group_start) - 1
            new_vals = np.zeros(group_id[-1] + 1, dtype=vals.dtype)
            np.add.at(new_vals, group_id, vals)
            keep = np.flatnonzero(group_start)
            rows, cols, vals = rows[keep], cols[keep], new_vals

    counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return csr_from_arrays(row_ptr, cols, vals, n_cols=n_cols)


def csr_from_dense(a, keep_zeros: bool = False) -> CSRMatrix:
    """Dense -> CSR (tests and tiny problems)."""
    a = np.asarray(a)
    if keep_zeros:
        rows, cols = np.indices(a.shape)
        rows, cols = rows.ravel(), cols.ravel()
        vals = a.ravel()
    else:
        rows, cols = np.nonzero(a)
        vals = a[rows, cols]
    return csr_from_coo(rows, cols, vals, n_rows=a.shape[0], n_cols=a.shape[1])


@dataclasses.dataclass(frozen=True)
class RowBlockCSR:
    """Host container for rows ``[row_lo, row_hi)`` of a global CSR matrix
    (``gmres_tpu/sparse.py:RowBlockCSR``): the per-host input form of a
    distributed solve.  A rank loads only its own rows from disk
    (``io/loader.py:load_matrix_rows``), so it holds the O(n) global
    ``row_ptr`` and its local entries, never the global entry arrays.
    Columns are global; the arrays are numpy."""

    row_ptr: np.ndarray   # (n_rows+1,) int64, the GLOBAL assembled row pointer
    col_idx: np.ndarray   # local entries, global columns
    vals: np.ndarray      # local entries
    row_lo: int
    row_hi: int
    n_rows: int           # global
    n_cols: int           # global

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def local_nnz(self) -> int:
        return int(self.row_ptr[self.row_hi] - self.row_ptr[self.row_lo])

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def entries(self, lo: int, hi: int):
        """(col_idx, vals) views for global rows ``[lo, hi)``, which must
        lie inside the loaded block."""
        if not (self.row_lo <= lo and hi <= self.row_hi and lo <= hi):
            raise IndexError(f"rows [{lo}, {hi}) outside owned block "
                             f"[{self.row_lo}, {self.row_hi})")
        base = int(self.row_ptr[self.row_lo])
        a = int(self.row_ptr[lo]) - base
        b = int(self.row_ptr[hi]) - base
        return self.col_idx[a:b], self.vals[a:b]

    def astype(self, dtype) -> "RowBlockCSR":
        dt = np.dtype(dtype)
        if dt == self.vals.dtype:
            return self
        return dataclasses.replace(self, vals=self.vals.astype(dt))

    def local_block(self) -> CSRMatrix:
        """The loaded rows as a CSRMatrix (local rows, global columns)."""
        rp = self.row_ptr[self.row_lo:self.row_hi + 1] - self.row_ptr[self.row_lo]
        return csr_from_arrays(rp, self.col_idx, self.vals, n_cols=self.n_cols)
