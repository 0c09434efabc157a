"""Synthetic test matrices, built on the host in numpy: the stencil
Laplacians (5- and 7-point) and the nonsymmetric convection-diffusion operator that the
benchmark solves, the jittered-stencil unstructured mesh that DIA refuses,
and a random diagonally dominant pattern for tests.  Each returns a
`CSRMatrix` with a guaranteed diagonal and sorted rows, entry for entry the
arrays ``gmres_tpu.io.synth`` builds.
"""

from __future__ import annotations

import numpy as np

from gmres_tpu_torch.sparse import CSRMatrix, csr_from_coo


def poisson_2d(nx: int, ny: int | None = None, dtype=np.float64) -> CSRMatrix:
    """5-point Laplacian on an nx-by-ny grid (SPD, like ecology2/apache2)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx % nx, idx // nx

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for cond, off in (
        (ix > 0, -1),
        (ix < nx - 1, +1),
        (iy > 0, -nx),
        (iy < ny - 1, +nx),
    ):
        sel = idx[cond]
        rows.append(sel)
        cols.append(sel + off)
        vals.append(np.full(sel.shape[0], -1.0))
    return csr_from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        n_rows=n,
    )


def poisson_3d(nx: int, ny: int | None = None, nz: int | None = None,
               dtype=np.float64) -> CSRMatrix:
    """7-point Laplacian on an nx*ny*nz grid (like thermal2/G3_circuit scale)."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 6.0)]
    for cond, off in (
        (ix > 0, -1),
        (ix < nx - 1, +1),
        (iy > 0, -nx),
        (iy < ny - 1, +nx),
        (iz > 0, -nx * ny),
        (iz < nz - 1, +nx * ny),
    ):
        sel = idx[cond]
        rows.append(sel)
        cols.append(sel + off)
        vals.append(np.full(sel.shape[0], -1.0))
    return csr_from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        n_rows=n,
    )


def convection_diffusion_2d(
    nx: int, ny: int | None = None, beta: float = 20.0, dtype=np.float64
) -> CSRMatrix:
    """Upwinded convection-diffusion on a 2D grid: nonsymmetric, the kind of
    problem GMRES exists for."""
    ny = ny or nx
    n = nx * ny
    h = 1.0 / (nx + 1)
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx % nx, idx // nx

    c = beta * h
    diag = 4.0 + c
    west, east = -1.0 - c, -1.0
    south, north = -1.0, -1.0

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, diag)]
    for cond, off, v in (
        (ix > 0, -1, west),
        (ix < nx - 1, +1, east),
        (iy > 0, -nx, south),
        (iy < ny - 1, +nx, north),
    ):
        sel = idx[cond]
        rows.append(sel)
        cols.append(sel + off)
        vals.append(np.full(sel.shape[0], v))
    return csr_from_coo(
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals).astype(dtype),
        n_rows=n,
    )


def random_sparse(
    n: int,
    row_nnz: int = 8,
    seed: int = 0,
    diag_dominance: float = 1.5,
    dtype=np.float64,
) -> CSRMatrix:
    """Random sparse matrix with guaranteed diagonal dominance (safe GMRES
    convergence for unit tests)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    cols = rng.integers(0, n, size=n * row_nnz)
    vals = rng.standard_normal(n * row_nnz)
    # drop diagonal hits, add dominant diagonal explicitly
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    d_rows = np.arange(n, dtype=np.int64)
    row_abs = np.zeros(n)
    np.add.at(row_abs, rows, np.abs(vals))
    d_vals = diag_dominance * (row_abs + 1.0)
    return csr_from_coo(
        np.concatenate([rows, d_rows]),
        np.concatenate([cols, d_rows]),
        np.concatenate([vals, d_vals]).astype(dtype),
        n_rows=n,
    )


def unstructured_mesh(
    n: int, nx: int | None = None, jitter: int = 16, run: int = 3,
    seed: int = 0, dtype=np.float64,
) -> CSRMatrix:
    """Jittered-stencil 'unstructured mesh': row i couples to runs of
    ``run`` consecutive columns at i-1 and at i +- (nx + j(i)) with
    per-row random jitter, the shape of an RCM-ordered FEM/mesh matrix:
    smooth per-row offsets but thousands of distinct diagonals, so
    ``dia.from_csr`` refuses and the SELL format (``ops/sell.py``) is
    exercised.  ``run=3`` gives ~10 nnz/row (2D-FEM density), ``run=8``
    ~25 (3D FEM / cage-class)."""
    if nx is None:
        nx = max(4, int(round(n ** 0.5)))
    rng = np.random.default_rng(seed)
    i = np.arange(n, dtype=np.int64)
    j_up = rng.integers(-jitter, jitter + 1, size=n)
    j_dn = rng.integers(-jitter, jitter + 1, size=n)
    base = [i - 1 + k for k in range(run)]
    up = [i - nx + j_up + k for k in range(run)]
    dn = [i + nx + j_dn + k for k in range(run)]
    cols = np.clip(np.concatenate(base + up + dn), 0, n - 1)
    rows = np.tile(i, 3 * run)
    vals = rng.standard_normal(rows.shape[0])
    rows = np.concatenate([rows, i])
    cols = np.concatenate([cols, i])
    vals = np.concatenate([vals, np.full(n, 3.0 * run + 1.0)])
    return csr_from_coo(rows, cols, vals.astype(dtype), n_rows=n)
