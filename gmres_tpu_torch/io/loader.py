"""Matrix and vector loading with the reference's CSR-build contract
(``gmres_tpu/io/loader.py``; the reference's ``LoadMatrix.hpp:17-233``).

- accepts ``coordinate x (real|integer) x (general|symmetric)`` only
  (``LoadMatrix.hpp:49-54``);
- symmetric files are expanded to full storage (every off-diagonal entry is
  mirrored, ``LoadMatrix.hpp:79-83,118-124``);
- an explicit diagonal entry is guaranteed for every row: a zero-valued
  placeholder, overwritten by the file's value, the last occurrence winning
  (``LoadMatrix.hpp:97-101,110-112``); duplicated off-diagonal entries are
  kept as separate stored entries;
- each row's entries are sorted by column with a stable sort, so duplicate
  (row, col) pairs keep the reference's insertion order
  (``LoadMatrix.hpp:128-145``).

A non-square matrix raises ``ValueError``, where the reference conflates M
and N (``LoadMatrix.hpp:62-66``).  Everything runs on the host in numpy; the
returned ``CSRMatrix`` lies on the CPU.  ``load_matrix_rows`` loads one
rank's row block of the same assembly (the per-host input of
``solve_distributed``).
"""

from __future__ import annotations

import os

import numpy as np

from gmres_tpu_torch.io import mmio
from gmres_tpu_torch.sparse import CSRMatrix, RowBlockCSR, csr_from_arrays


def assemble_reference_csr(rows, cols, vals, n: int,
                           symmetric: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO -> CSR with the reference's diagonal, symmetry and duplicate
    semantics.  Returns (row_ptr int32, col_idx int32, vals float64)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)

    diag_mask = rows == cols
    # the guaranteed diagonal: placeholder 0, overwritten per file entry
    diag_vals = np.zeros(n, dtype=np.float64)
    diag_vals[rows[diag_mask]] = vals[diag_mask]

    off_r, off_c, off_v = rows[~diag_mask], cols[~diag_mask], vals[~diag_mask]
    all_r = [np.arange(n, dtype=np.int64), off_r]
    all_c = [np.arange(n, dtype=np.int64), off_c]
    all_v = [diag_vals, off_v]
    if symmetric:
        all_r.append(off_c)
        all_c.append(off_r)
        all_v.append(off_v)
    r = np.concatenate(all_r)
    c = np.concatenate(all_c)
    v = np.concatenate(all_v)

    # stable by (row, col): duplicates keep their concatenation order
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    counts = np.bincount(r, minlength=n).astype(np.int64)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr.astype(np.int32), c.astype(np.int32), v


def load_matrix(path: str | os.PathLike, dtype=np.float64) -> CSRMatrix:
    """The reference's ``LoadMatrix<Scalar>`` (``LoadMatrix.hpp:17-154``)."""
    header, data = mmio.read(path)
    if not (header.is_coordinate and header.field in ("real", "integer")
            and header.symmetry in ("general", "symmetric")):
        raise ValueError("Unsupported matrix type")
    if header.n_rows != header.n_cols:
        raise ValueError(
            f"non-square matrix ({header.n_rows}x{header.n_cols}); the "
            "reference loader only supports square matrices")
    rows, cols, vals = data
    n = header.n_rows
    row_ptr, col_idx, v = assemble_reference_csr(rows, cols, vals, n,
                                                 symmetric=header.is_symmetric)
    return csr_from_arrays(row_ptr, col_idx, v.astype(dtype), n_cols=n)


def assemble_reference_csr_rows(rows, cols, vals, n: int, row_lo: int, row_hi: int,
                                symmetric: bool):
    """``assemble_reference_csr`` restricted to assembled rows ``[row_lo,
    row_hi)``, equal to slicing the whole assembly: the inputs are the kept
    entries of ``mmio.read_coordinate_rows`` in file order, so the stable
    sort keeps duplicate (row, col) pairs in the reference's insertion order
    (the diagonal placeholder, the direct entries, the mirrored ones).
    Returns (row_ptr with local offsets, col_idx int32, vals float64)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    nb = row_hi - row_lo

    diag_mask = rows == cols
    in_blk_d = diag_mask & (rows >= row_lo) & (rows < row_hi)
    diag_vals = np.zeros(nb, dtype=np.float64)
    diag_vals[rows[in_blk_d] - row_lo] = vals[in_blk_d]  # the last occurrence wins

    off = ~diag_mask
    direct = off & (rows >= row_lo) & (rows < row_hi)
    block = np.arange(row_lo, row_hi, dtype=np.int64)
    all_r, all_c, all_v = [block, rows[direct]], [block, cols[direct]], [diag_vals,
                                                                         vals[direct]]
    if symmetric:
        mirror = off & (cols >= row_lo) & (cols < row_hi)
        all_r.append(cols[mirror])
        all_c.append(rows[mirror])
        all_v.append(vals[mirror])
    r = np.concatenate(all_r)
    c = np.concatenate(all_c)
    v = np.concatenate(all_v)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    row_ptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(r - row_lo, minlength=nb), out=row_ptr[1:])
    return row_ptr, c.astype(np.int32), v


def load_matrix_rows(path: str | os.PathLike, row_lo: int, row_hi: int,
                     dtype=np.float64) -> RowBlockCSR:
    """Rows ``[row_lo, row_hi)`` of ``load_matrix(path)`` as a
    ``RowBlockCSR`` (``gmres_tpu/io/loader.py:load_matrix_rows``): the file
    streamed keeping only the entries the block needs, the reference's CSR
    contract applied to the block, the global row pointer from a count of
    every row's assembled entries.  Every rank that calls it with its own
    range holds exactly its slice of the whole assembly."""
    header, rows, cols, vals, counts = mmio.read_coordinate_rows(path, row_lo, row_hi)
    if not (header.field in ("real", "integer")
            and header.symmetry in ("general", "symmetric")):
        raise ValueError("Unsupported matrix type")
    if header.n_rows != header.n_cols:
        raise ValueError(
            f"non-square matrix ({header.n_rows}x{header.n_cols}); the "
            "reference loader only supports square matrices")
    n = header.n_rows
    if not 0 <= row_lo <= row_hi <= n:
        raise ValueError(f"bad row range [{row_lo}, {row_hi}) for n={n}")
    rp_local, ci, v = assemble_reference_csr_rows(rows, cols, vals, n, row_lo, row_hi,
                                                  symmetric=header.is_symmetric)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if row_ptr[row_hi] - row_ptr[row_lo] != rp_local[-1]:
        raise ValueError("the assembled block's entry count disagrees with the global count")
    return RowBlockCSR(row_ptr=row_ptr, col_idx=ci, vals=v.astype(dtype), row_lo=row_lo,
                       row_hi=row_hi, n_rows=n, n_cols=n)


def load_vector(path: str | os.PathLike, col: int = 0, dtype=np.float64) -> np.ndarray:
    """The reference's ``LoadVector`` (``LoadMatrix.hpp:156-233``): column
    ``col`` of a dense array file, or the ``col``-column entries of a
    coordinate file scattered into a zero vector."""
    header, data = mmio.read(path)
    if col >= header.n_cols:
        raise ValueError(f"Column {col} is too large for the {header.n_cols} vectors")
    if header.is_coordinate:
        rows, cols, vals = data
        out = np.zeros(header.n_rows, dtype=np.float64)
        sel = cols == col
        out[rows[sel]] = vals[sel]
        return out.astype(dtype)
    return np.asarray(data)[:, col].astype(dtype)
