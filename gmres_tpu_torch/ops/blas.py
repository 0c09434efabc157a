"""BLAS-1 style reductions as plain torch.

The accumulation dtype is the vector's (BLAS sdot/ddot semantics).  Each
reduction takes an optional ``comm`` (``parallel/comm.py``): in a
distributed solve the rank's partial is summed over the ranks by one
collective, where the JAX package psums.  The JAX package's double-float
fast dot (``gmres_tpu/ops/blas.py:_df64_dot_fast``) existed only for the
TPU's missing fp64 units and has no counterpart here.
"""

from __future__ import annotations

import torch


def all_reduce(t: torch.Tensor, comm=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``comm``; ``t`` itself without one."""
    return t if comm is None else comm.all_reduce_sum(t)


def dot(x: torch.Tensor, y: torch.Tensor, comm=None) -> torch.Tensor:
    """<x, y> in the dtype of x."""
    return all_reduce(torch.dot(x, y.to(x.dtype)), comm)


def nrm2(x: torch.Tensor, comm=None) -> torch.Tensor:
    """Euclidean norm as sqrt(sum(x^2)) (no overflow scaling, like the
    reference's operating range)."""
    return torch.sqrt(all_reduce(torch.dot(x, x), comm))


def matvec_rows(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u = V @ w for a row-stored basis V (m+1, n)."""
    return torch.mv(V, w.to(V.dtype))
