"""The plain reference that decides ``correct``: the operator's product and
a solution's backward error, in float64, from the benchmark's own CSR
arrays.

It imports torch and numpy only: nothing of the program (``gmres_tpu_torch``),
nor JAX, nor the JAX package (a CPU test holds it to that), and it takes
nothing the program made but the solutions it judges.  The rows are held
padded to the longest row (ELL: each row's columns and values, the padding
a zero value at the row's own column) and multiplied in blocks of rows, so
that a block's gather stays small beside the card's memory.

The number judged on a solution x is its normwise backward error,

    ||b - A x||_2 / (||b||_2 + ||A||_F ||x||_2),

the quantity the configuration's tolerance bounds and the solver reports
(the reference's ``check_initial``, ``IterUtil.hpp``), with ``||A||_F``
from the float64 values.  The harness compares it with the tolerance, and
with the backward error the solve reported for the same x.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 20


class Reference:
    def __init__(self, row_ptr: np.ndarray, cols: np.ndarray, vals: np.ndarray, device):
        n = row_ptr.shape[0] - 1
        counts = np.diff(row_ptr)
        width = int(counts.max())
        rows = np.repeat(np.arange(n, dtype=np.int64), counts)
        slot = np.arange(cols.shape[0], dtype=np.int64) - np.repeat(row_ptr[:-1], counts)
        ell_cols = np.repeat(np.arange(n, dtype=np.int64)[:, None], width, axis=1)
        ell_vals = np.zeros((n, width), dtype=np.float64)
        ell_cols[rows, slot] = cols
        ell_vals[rows, slot] = vals
        self.n = n
        self.device = torch.device(device)
        self.cols = torch.from_numpy(ell_cols).to(self.device)
        self.vals = torch.from_numpy(ell_vals).to(self.device)
        self.a_fro = float(torch.linalg.vector_norm(torch.from_numpy(np.asarray(vals, np.float64))))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x in float64."""
        x = x.to(self.device, torch.float64)
        y = torch.empty(self.n, dtype=torch.float64, device=self.device)
        for s in range(0, self.n, BLOCK_ROWS):
            e = min(s + BLOCK_ROWS, self.n)
            y[s:e] = (self.vals[s:e] * x[self.cols[s:e]]).sum(dim=1)
        return y

    def backward_error(self, b: torch.Tensor, x: torch.Tensor) -> float:
        b = b.to(self.device, torch.float64)
        x = x.to(self.device, torch.float64)
        r = b - self.matvec(x)
        den = float(torch.linalg.vector_norm(b)) + self.a_fro * float(torch.linalg.vector_norm(x))
        return float(torch.linalg.vector_norm(r)) / den

