"""Double-float (two-fp32) vector math: the ``df64`` inner precision tier
(``gmres_tpu/ops/df64.py``).

An fp64-quality vector is carried as an (hi, lo) pair of fp32 tensors
(``ops/eft.py``); the inner loop's vector algebra runs on pairs, while the
O(m^2) scalar machinery (H, Givens, the triangular solves) stays true fp64.
The H100 has fp64 units, but the tier is defined as pair arithmetic, and
the JAX package computes it so on every backend: pairs keep the port
within reach of the reference's rounding.

The basis sweeps go through kernels K9-K11 on a CUDA tensor and their plain
versions on a CPU one (``ops/cuda/df64_orth_kernel.py``), and so do the
dot and norm, as a one-row sweep (the TPU's ``ops/blas.py:46-56`` rode
the same kernel).  A sweep reads rows 0..rows-1 of the basis; the solver
passes rows = k + 1, and rows past k are zero, so the result is the JAX
package's sweep over all m+1 rows.

In a distributed solve the vectors and the basis are the rank's rows, and
``comm`` (``parallel/comm.py``) sums each reduction over the ranks where
the JAX package sums pairs across shards (``_psum_pairs``,
``gmres_tpu/ops/df64.py:71-76``).  K9-K11 return each rank's sum as fp64
(the pair merged, about 2^-48 relative), so the ranks' fp64 values are
added in rank order: never their hi parts alone, which would round each
cross-rank sum to fp32 and the tier with it.  A rank's SpMV is the JAX
package's route for a plain fp64 operator: merge, the fp64 halo SpMV (K12
on the card), split.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.blas import all_reduce
from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
from gmres_tpu_torch.ops.dia import DF64Dia, dia_spmv_df64
from gmres_tpu_torch.ops.eft import (  # noqa: F401  (re-exports)
    df_add,
    df_basis_comb,
    df_mul,
    df_sum,
    merge_f64,
    quick_two_sum,
    split_f64,
    two_prod,
    two_sum,
)
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.precond.apply import apply_preconditioner, typesafe_apply
from gmres_tpu_torch.precond.build import IdentityPrec

_f64 = torch.float64


def promote_f32(x: torch.Tensor):
    """Exact fp32 -> pair."""
    return x, torch.zeros_like(x)


def df_sub(ah, al, bh, bl):
    return df_add(ah, al, -bh, -bl)


def df_scale(h, l, sh, sl):
    """Pair vector times a scalar pair."""
    return df_mul(h, l, sh, sl)


def df_dot(ah, al, bh, bl, comm=None) -> torch.Tensor:
    """<a, b> as an fp64 0-d tensor: a one-row K9 sweep of a against b."""
    return all_reduce(dk.df_gram(ah.unsqueeze(0), al.unsqueeze(0), bh, bl, 1)[0], comm)


def df_norm(h, l, comm=None) -> torch.Tensor:
    return torch.sqrt(df_dot(h, l, h, l, comm))


def df_gram(Vh, Vl, wh, wl, rows: int | None = None, comm=None) -> torch.Tensor:
    """u[j] = <V_j, w> for the first ``rows`` rows (all by default), fp64
    (m+1,) with zeros past ``rows``."""
    return all_reduce(dk.df_gram(Vh, Vl, wh, wl, Vh.shape[0] if rows is None else rows), comm)


def df_update(wh, wl, Vh, Vl, u64):
    """w - sum_j u_j V_j (the CGS/MGS elimination update) over every row of
    V; the plain form of K10's and K11's update pass."""
    ch, cl = df_basis_comb(Vh, Vl, u64)
    return df_sub(wh, wl, ch, cl)


def spmv_df64_pair(A, xh, xl, comm=None):
    """y = A x on a pair, returned as a pair: a ``DF64Dia`` through K8 (its
    plain version on the CPU); any other operator (a rank's block with
    ``comm``) holds fp64 values, and x goes through merge, the fp64 SpMV (K1,
    K5 or K12 on the card) and split (``gmres_tpu/ops/df64.py:144-148``)."""
    if isinstance(A, DF64Dia):
        return dia_spmv_df64(A, xh, xl)
    return split_f64(spmv(A, merge_f64(xh, xl), comm))


def df_cgs(Vh, Vl, k: int, wh, wl):
    """One classical Gram-Schmidt pass over rows 0..k: (u, w')."""
    u = dk.df_gram(Vh, Vl, wh, wl, k + 1)
    wh, wl, _ = dk.df_update_sumsq(Vh, Vl, wh, wl, u, k + 1)
    return u, wh, wl


def df_mgs(Vh, Vl, k: int, wh, wl, comm=None):
    """Modified Gram-Schmidt, the k+1 sequential pair dot/axpy steps
    (``Orthogonalization.hpp:91-107``): for each row j, a one-row K9 (h_j,
    summed over the ranks before it is used) and a one-row K11 (w -= h_j
    v_j); the last K11's sum of squares is ||w'||^2.  Returns (h, wh', wl',
    ||w'||), h and the norm fp64."""
    h = torch.zeros(Vh.shape[0], dtype=_f64, device=Vh.device)
    ss = None
    for j in range(k + 1):
        vh, vl = Vh[j:j + 1], Vl[j:j + 1]
        hj = all_reduce(dk.df_gram(vh, vl, wh, wl, 1), comm)
        wh, wl, ss = dk.df_update_sumsq(vh, vl, wh, wl, hj, 1)
        h[j] = hj[0]
    return h, wh, wl, torch.sqrt(all_reduce(ss, comm))


def df_mgs_lowsync_step(Vh, Vl, k: int, wh, wl, L: torch.Tensor, comm=None):
    """One-reduce ICWY MGS step on pairs (``gmres_tpu/ops/df64.py:179-213``):
    two K9 sweeps (V w, and from k = 1 on V v_k over rows < k for row k of
    the fp64 coupling matrix L, updated in place), summed over the ranks in
    one collective, the unit-lower-triangular fp64 solve for h, then K11
    for w' = w - h^T V and ||w'||^2.  Returns (h, w', ||w'||^2, L)."""
    rows = k + 1
    u = dk.df_gram(Vh, Vl, wh, wl, rows)
    ell = dk.df_gram(Vh, Vl, Vh[k], Vl[k], k) if k else torch.zeros_like(u)
    if comm is not None:
        u, ell = comm.all_reduce_sum(torch.stack([u, ell])).unbind()
    L[k, :k] = ell[:k]
    h = torch.linalg.solve_triangular(L, u.unsqueeze(1), upper=False,
                                      unitriangular=True).squeeze(1)
    wh, wl, ss = dk.df_update_sumsq(Vh, Vl, wh, wl, h, rows)
    return h, wh, wl, all_reduce(ss, comm), L


def df_orthonormalize_step(kind: str, Vh, Vl, k: int, wh, wl, orth_steps: int = 2, comm=None):
    """Orthogonalize the pair w against rows 0..k and take the norm:
    ``(h_col, wh', wl', ||w'||)``, h_col and the norm fp64.  CGS is K9 then
    K11; CGSR K9, K10 for each further pass, then K11 (the JAX package's
    fused TPU chain, ``gmres_tpu/ops/df64.py:226-248``), each sweep's sum
    over the ranks taken before the next sweep uses it; MGS is
    ``df_mgs``."""
    rows = k + 1
    if kind == "mgs":
        return df_mgs(Vh, Vl, k, wh, wl, comm)
    if kind not in ("cgs", "cgsr"):
        raise ValueError(f"unknown orthogonalization {kind!r}")
    u = all_reduce(dk.df_gram(Vh, Vl, wh, wl, rows), comm)
    h = u
    for _ in range((orth_steps if kind == "cgsr" else 1) - 1):
        wh, wl, u = dk.df_update_gram(Vh, Vl, wh, wl, u, rows)
        u = all_reduce(u, comm)
        h = h + u
    wh, wl, ss = dk.df_update_sumsq(Vh, Vl, wh, wl, u, rows)
    return h, wh, wl, torch.sqrt(all_reduce(ss, comm))


def typesafe_apply_df64(M, wh, wl, comm=None):
    """Preconditioner application on a pair with the reference's typesafe
    round trip (``gmres.cpp:12-22``): an fp32 preconditioner sees the fp32
    value, hi, and its result promotes exactly; an fp64 one sees the fp64
    merge and its result is split."""
    if isinstance(M, IdentityPrec):
        return wh, wl
    if M.inv_diag.dtype == torch.float32:
        return promote_f32(apply_preconditioner(M, wh, comm))
    return split_f64(typesafe_apply(M, merge_f64(wh, wl), comm))
