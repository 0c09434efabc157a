"""Preconditioner application.

``typesafe_apply`` parity: when the preconditioner dtype differs from the
vector dtype, the reference round-trips through a cast
(``gmres.cpp:12-17``).
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.precond.build import IdentityPrec, JacobiPrec


def apply_preconditioner(M, w: torch.Tensor) -> torch.Tensor:
    """M^{-1} w in M's dtype."""
    if isinstance(M, IdentityPrec):
        return w
    if isinstance(M, JacobiPrec):
        return M.inv_diag * w
    raise TypeError(f"unknown preconditioner {type(M).__name__}")


def typesafe_apply(M, w: torch.Tensor) -> torch.Tensor:
    """Apply M in its own dtype, round-tripping w if needed."""
    if isinstance(M, IdentityPrec):
        return w
    m_dtype = M.inv_diag.dtype
    if w.dtype == m_dtype:
        return apply_preconditioner(M, w)
    return apply_preconditioner(M, w.to(m_dtype)).to(w.dtype)
