"""ILU(0) factorization and triangular dependency levels (host, setup time).

Carried from ``gmres_tpu.precond.ilu0`` and ``gmres_tpu.precond.level_ilu``
(not imported from them).  Algorithm parity with the reference's
``ilu0_impl`` (``kernels_mkl.cpp:416-496``):

- sequential IKJ ILU(0) on the CSR pattern, whose rows are sorted and
  store their diagonal;
- diagonal boost: pivots of rows 1..n-1 with magnitude below
  ``alpha = eps(factor_dtype) * max_i ||row_i(A)||_1`` are clamped to
  ``±alpha`` (row 0 is not boosted, as in the reference);
- factors computed in fp64 and downcast to the preconditioner dtype.

``factor_dtype`` is a torch dtype.  The pivot floor takes its eps from
``torch.finfo`` (2^-7 for bf16, as the JAX package's ``ml_dtypes`` gives,
which the card's machine may lack), and the fp64 factor comes back as a
tensor rounded to that dtype by torch.

The fast path is the host C++ helper ``csrc/ilu_host.cpp``, built at first
use (``ops/cuda/_build.py:host_library``); at 1M rows the Python loop of
``ilu0_factorize_numpy`` takes minutes.  If the helper cannot be built,
``ilu0_factorize`` and the level functions raise: nothing falls back to
the numpy twin, which is kept for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from gmres_tpu_torch.ops.cuda._build import host_library


def diag_positions(row_ptr: np.ndarray, col_idx: np.ndarray) -> np.ndarray:
    """Position of the first entry with col >= row in each row: row_ptr[i]
    plus the count of the row's columns below i (rows sorted by column)."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    below = (col_idx[: rp[-1]].astype(np.int64) < row_ids).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(below)])
    return rp[:-1] + (cum[rp[1:]] - cum[rp[:-1]])


def _boost_alpha(rp: np.ndarray, v: np.ndarray, factor_dtype: torch.dtype) -> float:
    """eps(factor dtype) * the largest row 1-norm of A."""
    n = rp.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    row_abs = np.zeros(n)
    np.add.at(row_abs, row_ids, np.abs(v[: rp[-1]]))
    return float(torch.finfo(factor_dtype).eps) * float(row_abs.max(initial=0.0))


def ilu0_factorize_numpy(row_ptr, col_idx, vals, factor_dtype=torch.float64):
    """Pure-numpy sequential ILU(0), the twin of the host helper.  Returns
    (factor_vals, diag_positions): the combined L\\U factor on A's pattern
    (unit-diagonal L stored without its ones), a tensor of factor_dtype."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    ci = col_idx.astype(np.int64)
    v = vals.astype(np.float64).copy()
    alpha = _boost_alpha(rp, v, factor_dtype)
    diag = diag_positions(rp, ci)
    for i in range(1, n):
        row_end = rp[i + 1]
        k_ind = rp[i]
        while ci[k_ind] < i:
            k = ci[k_ind]
            factor = v[k_ind] / v[diag[k]]
            v[k_ind] = factor
            prev_ind, prev_end = diag[k] + 1, rp[k + 1]
            j_ind = k_ind + 1
            while j_ind < row_end and prev_ind < prev_end:
                cj, cp = ci[j_ind], ci[prev_ind]
                if cp < cj:
                    prev_ind += 1
                elif cp > cj:
                    j_ind += 1
                else:
                    v[j_ind] -= factor * v[prev_ind]
                    prev_ind += 1
                    j_ind += 1
            k_ind += 1
        dv = v[diag[i]]
        if dv >= 0:
            if dv < alpha:
                v[diag[i]] = alpha
        elif dv > -alpha:
            v[diag[i]] = -alpha
    return torch.from_numpy(v).to(factor_dtype), diag


def _csr64(row_ptr, col_idx):
    rp = np.ascontiguousarray(row_ptr, dtype=np.int64)
    return rp, np.ascontiguousarray(col_idx[: rp[-1]], dtype=np.int64)


def ilu0_factorize(row_ptr, col_idx, vals, factor_dtype=torch.float64):
    """ILU(0) through the host helper, bit-identical to
    ``ilu0_factorize_numpy``."""
    lib = host_library()
    rp, ci = _csr64(row_ptr, col_idx)
    v = np.array(vals[: rp[-1]], dtype=np.float64)
    diag = np.empty(rp.shape[0] - 1, dtype=np.int64)
    rc = lib.ilu_host_factorize(diag.shape[0], rp.ctypes.data, ci.ctypes.data,
                                v.ctypes.data, diag.ctypes.data,
                                _boost_alpha(rp, v, factor_dtype))
    if rc != 0:
        raise ValueError(f"ILU(0): row {-rc - 1} stores no entry on or right of "
                         "its diagonal")
    return torch.from_numpy(v).to(factor_dtype), diag


def triangular_levels(row_ptr, col_idx, diag) -> tuple[np.ndarray, np.ndarray]:
    """Per-row dependency levels (lev_l, lev_u) of the strict triangles:
    level 0 rows have no in-triangle dependency, level k rows depend on a
    level k-1 row and nothing deeper."""
    lib = host_library()
    rp, ci = _csr64(row_ptr, col_idx)
    d = np.ascontiguousarray(diag, dtype=np.int64)
    n = rp.shape[0] - 1
    lev_l = np.empty(n, dtype=np.int64)
    lev_u = np.empty(n, dtype=np.int64)
    lib.ilu_host_levels(n, rp.ctypes.data, ci.ctypes.data, d.ctypes.data,
                        lev_l.ctypes.data, lev_u.ctypes.data)
    return lev_l, lev_u


def triangular_level_counts(row_ptr, col_idx, diag) -> tuple[int, int]:
    """Dependency-level counts (nilpotency indices) of the strict-lower and
    strict-upper parts: that many Jacobi sweeps of a triangle give its
    exact solve."""
    lev_l, lev_u = triangular_levels(row_ptr, col_idx, diag)
    return int(lev_l.max(initial=0)) + 1, int(lev_u.max(initial=0)) + 1


def ilu_trisolve_host(row_ptr, col_idx, vals, diag, b) -> np.ndarray:
    """Exact sequential L then U substitution on the combined factor, in
    fp64 (the reference's ilusv): the host oracle of the triangular-solve
    kernels."""
    lib = host_library()
    rp, ci = _csr64(row_ptr, col_idx)
    v = np.ascontiguousarray(vals[: rp[-1]], dtype=np.float64)
    d = np.ascontiguousarray(diag, dtype=np.int64)
    x = np.array(b, dtype=np.float64)
    lib.ilu_host_trisolve(d.shape[0], rp.ctypes.data, ci.ctypes.data, v.ctypes.data,
                          d.ctypes.data, x.ctypes.data)
    return x
