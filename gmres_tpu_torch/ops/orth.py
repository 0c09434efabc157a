"""Orthogonalization: CGS and CGSR (``Orthogonalization.hpp:76-136``).

The Krylov basis is row-stored, ``V`` of shape (m+1, n).  The step index
``k`` is a host int here (the Arnoldi loop is a Python loop), so the
j <= k mask of the reference is simply a sweep over rows 0..k: every
basis sweep reads only those rows, through the kernels K2/K3 on the card
(``ops/cuda/orth_kernel.py``) in fp32 and fp64 alike.  The JAX package's
``assume_zero_tail`` flag has nothing left to select and is not carried.

MGS is not ported yet.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.blas import nrm2
from gmres_tpu_torch.ops.cuda.orth_kernel import cgsr2, gram, update_sumsq


def _mgs_missing():
    return NotImplementedError("orth='mgs' (sequential and one-reduce ICWY MGS) "
                               "is slice 4 of the port")


def cgs(V: torch.Tensor, k: int, w: torch.Tensor):
    """Classical Gram-Schmidt (``Orthogonalization.hpp:76-89``): (h, w')."""
    u = gram(V, w, k + 1)
    w2, _ = update_sumsq(V, w, u, k + 1)
    return u, w2


def cgsr(V: torch.Tensor, k: int, w: torch.Tensor, orth_steps: int = 2):
    """CGS with re-orthogonalization (``Orthogonalization.hpp:109-136``)."""
    h, w = cgs(V, k, w)
    for _ in range(orth_steps - 1):
        u, w = cgs(V, k, w)
        h = h + u
    return h, w


def orthogonalize(kind: str, V, k: int, w, orth_steps: int = 2):
    if kind == "cgs":
        return cgs(V, k, w)
    if kind == "cgsr":
        return cgsr(V, k, w, orth_steps)
    if kind == "mgs":
        raise _mgs_missing()
    raise ValueError(f"unknown orthogonalization {kind!r}")


def orthonormalize_step(kind: str, V, k: int, w, orth_steps: int = 2):
    """Orthogonalize w against rows 0..k of V and take the norm of the
    result: ``(h_col, w_orth, ||w_orth||)``.  The two-pass CGSR step is
    three basis sweeps (gram, update+gram, update+sum of squares) and CGS
    two, with the norm folded into the last sweep."""
    if kind == "cgsr" and orth_steps == 2:
        return cgsr2(V, w, k + 1)
    if kind == "cgs":
        u = gram(V, w, k + 1)
        w2, ss = update_sumsq(V, w, u, k + 1)
        return u, w2, torch.sqrt(ss)
    h, w = orthogonalize(kind, V, k, w, orth_steps)
    return h, w, nrm2(w)
