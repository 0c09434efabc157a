"""The 5-point upwind convection-diffusion operator on an nx-by-ny grid,
frozen here so that the benchmark's inputs do not move with the program's
``io/synth.py``: row ``i = ix + nx*iy`` couples to ``i-nx`` (-1), ``i-1``
(-1-c), itself (4+c), ``i+1`` (-1) and ``i+nx`` (-1), with ``c = beta*h``
and ``h = 1/(nx+1)``; neighbours off the grid are left out.  The entries
are those of ``gmres_tpu_torch.io.synth.convection_diffusion_2d`` (a CPU
test holds them equal), built row by row without a sort."""

from __future__ import annotations

import numpy as np


def build(nx: int, beta: float = 20.0, ny: int | None = None):
    ny = ny or nx
    n = nx * ny
    c = beta * (1.0 / (nx + 1))
    idx = np.arange(n, dtype=np.int64)
    ix, iy = idx % nx, idx // nx
    offsets = np.array([-nx, -1, 0, 1, nx], dtype=np.int64)
    values = np.array([-1.0, -1.0 - c, 4.0 + c, -1.0, -1.0])
    keep = np.stack([iy > 0, ix > 0, np.ones(n, dtype=bool), ix < nx - 1, iy < ny - 1], axis=1)
    cols = (idx[:, None] + offsets)[keep]
    vals = np.broadcast_to(values, (n, 5))[keep]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=1), out=row_ptr[1:])
    return row_ptr, cols, vals


def diagonals(nx: int, beta: float = 20.0, ny: int | None = None) -> int:
    return 5 if nx > 1 and (ny or nx) > 1 else 3
