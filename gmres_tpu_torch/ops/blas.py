"""BLAS-1 style reductions as plain torch.

The accumulation dtype is the vector's (BLAS sdot/ddot semantics).  The
JAX package's double-float fast dot (``gmres_tpu/ops/blas.py:_df64_dot_fast``)
existed only for the TPU's missing fp64 units and has no counterpart here.
"""

from __future__ import annotations

import torch


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> in the dtype of x."""
    return torch.dot(x, y.to(x.dtype))


def nrm2(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm as sqrt(sum(x^2)) (no overflow scaling, like the
    reference's operating range)."""
    return torch.sqrt(torch.dot(x, x))


def matvec_rows(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u = V @ w for a row-stored basis V (m+1, n)."""
    return torch.mv(V, w.to(V.dtype))
