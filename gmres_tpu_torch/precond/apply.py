"""Preconditioner application.

``typesafe_apply`` parity: when the preconditioner dtype differs from the
vector dtype, the reference round-trips through a cast
(``gmres.cpp:12-17``).

The ILU-Jacobi apply has the portable kernel's semantics
(``kernels.hpp:223-248``), with U including the diagonal:

    L phase (unit diagonal):  x <- b  - L_s x,            x_0 = b
    U phase:                  x <- x + D^-1 (b' - U x),   x_0 = b' (the L result)

Each sweep is one SpMV (K1 on DIA factors, K5 on sliced-ELL ones) and
elementwise torch ops.  The exact-ILU DIA form goes to kernel K6 (its
simplified U sweep x <- D^-1 (b' - U_s x), ``trisolve_kernel.py:32-36``) on
a CUDA tensor and to K6's plain versions on a CPU one.

In a distributed solve ``w`` is the rank's block and ``comm`` reaches each
sweep's SpMV (a halo exchange or an allgather, ``ops/spmv.py``); Jacobi
needs none, and neither do the sweeps of a block-Jacobi ILU's diagonal
block (``ILUJacobiPrec.block_local``, ``precond/bilu.py``), which run as
a single card's do.

``typesafe_apply_lanes`` applies M to the s lanes of a batched solve, each
lane with the bits of ``typesafe_apply``: identity and Jacobi broadcast, the
ILU-Jacobi sweeps run on ``spmv_lanes`` (K1's lane form on DIA factors), and
an exact-ILU DIA or level-scheduled M is applied lane by lane.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk
from gmres_tpu_torch.ops.spmv import spmv, spmv_lanes
from gmres_tpu_torch.precond.build import (
    ExactILUDIAPrec,
    IdentityPrec,
    ILUJacobiPrec,
    JacobiPrec,
)
from gmres_tpu_torch.precond.level_ilu import LevelILUPrec, level_ilu_apply


def _ilu_jacobi_apply(M: ILUJacobiPrec, w: torch.Tensor, comm=None, product=None) -> torch.Tensor:
    """The sweeps; ``product(A, x)`` is the SpMV (``spmv`` with ``comm``,
    or ``spmv_lanes`` for w of shape (s, n))."""
    if M.block_local:
        comm = None
    product = product or (lambda A, x: spmv(A, x, comm))
    x = w
    for _ in range(M.steps):
        x = w - product(M.lower, x)
    b2 = x
    for _ in range(M.steps):
        x = x + M.inv_diag * (b2 - product(M.upper, x))
    return x


def _exact_ilu_apply(M: ExactILUDIAPrec, w: torch.Tensor) -> torch.Tensor:
    args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u)
    steps = (M.steps_l_segs, M.steps_u_segs, M.seg) if M.seg else (M.steps_l, M.steps_u)
    if w.is_cuda:
        fn = tk.ilu_trisolve_segmented_cuda if M.seg else tk.ilu_trisolve_fused_cuda
        return fn(*args, *steps, schedule=M.schedule)
    fn = tk.ilu_trisolve_segmented_plain if M.seg else tk.ilu_trisolve_fused_plain
    return fn(*args, *steps)


def apply_preconditioner(M, w: torch.Tensor, comm=None) -> torch.Tensor:
    """M^{-1} w in M's dtype."""
    if isinstance(M, IdentityPrec):
        return w
    if isinstance(M, JacobiPrec):
        return M.inv_diag * w
    if isinstance(M, ILUJacobiPrec):
        return _ilu_jacobi_apply(M, w, comm)
    if comm is not None:
        raise TypeError(f"{type(M).__name__} has no distributed apply")
    if isinstance(M, ExactILUDIAPrec):
        return _exact_ilu_apply(M, w)
    if isinstance(M, LevelILUPrec):
        return level_ilu_apply(M, w)
    raise TypeError(f"unknown preconditioner {type(M).__name__}")


def typesafe_apply(M, w: torch.Tensor, comm=None) -> torch.Tensor:
    """Apply M in its own dtype, round-tripping w if needed."""
    if isinstance(M, IdentityPrec):
        return w
    m_dtype = M.inv_diag.dtype
    if w.dtype == m_dtype:
        return apply_preconditioner(M, w, comm)
    return apply_preconditioner(M, w.to(m_dtype), comm).to(w.dtype)


def typesafe_apply_lanes(M, W: torch.Tensor) -> torch.Tensor:
    """``typesafe_apply`` on each lane of W (s, n), with its bits."""
    if isinstance(M, IdentityPrec):
        return W
    m_dtype = M.inv_diag.dtype
    Wm = W.to(m_dtype)
    if isinstance(M, JacobiPrec):
        out = M.inv_diag * Wm
    elif isinstance(M, ILUJacobiPrec):
        out = _ilu_jacobi_apply(M, Wm, product=spmv_lanes)
    else:
        out = torch.stack([apply_preconditioner(M, w) for w in Wm])
    return out.to(W.dtype)
