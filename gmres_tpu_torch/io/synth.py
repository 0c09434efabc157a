"""Synthetic test matrices, built on the host in numpy: the stencil
Laplacian and the nonsymmetric convection-diffusion operator that the
benchmark solves.  Each returns a `CSRMatrix` with a guaranteed diagonal
and sorted rows, entry for entry the arrays ``gmres_tpu.io.synth`` builds.
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
