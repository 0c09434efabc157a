"""Orthogonalization: CGS, MGS and CGSR (``Orthogonalization.hpp:76-136``),
and the one-reduce ICWY form of MGS.

The Krylov basis is row-stored, ``V`` of shape (m+1, n).  The step index
``k`` is a host int here (the Arnoldi loop is a Python loop), so the
j <= k mask of the reference is simply a sweep over rows 0..k: every
basis sweep reads only those rows, through the kernels on the card
(``ops/cuda/orth_kernel.py``: K2, K2x2, K3; ``ops/cuda/mgs_kernel.py``: K7)
in fp32 and fp64 alike.  The JAX package's ``assume_zero_tail`` flag has
nothing left to select and is not carried.

The compressed basis stores ``V`` narrower than ``w`` (bf16 under an fp32
``w``, fp32 under fp64), and the bf16 inner tier sweeps a bf16 ``V`` against
a bf16 ``w``: the kernels' dtype forms sum in the accumulation dtype (fp32,
or fp64 under fp64) and return ``w``'s dtype (``ops/cuda/orth_kernel.py``),
and the norms here are taken in the accumulation dtype too, as the JAX
package takes them for a bf16 ``w`` (``gmres_tpu/ops/orth.py:318-323``).

In a distributed solve ``V`` and ``w`` are the rank's rows and ``comm``
(``parallel/comm.py``) sums each reduction over the ranks where the JAX
package psums: once after each gram and sum of squares, and for
sequential MGS once per basis row, in plain torch as the JAX package runs
it outside Pallas (``gmres_tpu/ops/orth.py:83-117``).
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.blas import all_reduce, nrm2
from gmres_tpu_torch.ops.cuda._build import acc_dtype
from gmres_tpu_torch.ops.cuda.mgs_kernel import mgs as mgs_sweep
from gmres_tpu_torch.ops.cuda.orth_kernel import cgsr2, gram, gram2, update, update_sumsq


def cgs(V: torch.Tensor, k: int, w: torch.Tensor, comm=None):
    """Classical Gram-Schmidt (``Orthogonalization.hpp:76-89``): (h, w')."""
    u = all_reduce(gram(V, w, k + 1), comm)
    return u, update(V, w, u, k + 1)


def mgs(V: torch.Tensor, k: int, w: torch.Tensor, comm=None):
    """Modified Gram-Schmidt (``Orthogonalization.hpp:91-107``): the k+1
    sequential dot/axpy pairs, one K7 launch on the card; distributed, the
    row loop with one collective a row, each dot and update computed in
    the accumulation dtype and rounded to w's (``gmres_tpu/ops/orth.py:
    100-116``: a bf16 or narrower-basis row is widened first).  Returns (h,
    w', ||w'||)."""
    if comm is None:
        return mgs_sweep(V, w, k + 1)
    acc = acc_dtype(w.dtype)
    h = torch.zeros(V.shape[0], dtype=w.dtype, device=V.device)
    for j in range(k + 1):
        vj = V[j].to(acc)
        hj = all_reduce(torch.dot(w.to(acc), vj), comm).to(w.dtype)
        w = (w.to(acc) - hj.to(acc) * vj).to(w.dtype)
        h[j] = hj
    wa = w.to(acc)
    return h, w, torch.sqrt(all_reduce(torch.dot(wa, wa), comm)).to(w.dtype)


def mgs_lowsync_step(V: torch.Tensor, k: int, w: torch.Tensor, L: torch.Tensor, comm=None):
    """One ICWY (one-reduce) MGS step (``gmres_tpu/ops/orth.py:119-210``):

        (u, l) = (V w, V v_k);   L[k, :k] = l[:k];
        h = (I + L)^{-1} u;      w' = w - h^T V,  with ||w'||^2

    two basis sweeps (K2x2, then K3 SUMSQ) and a unit-lower-triangular
    (m+1)x(m+1) solve; distributed, one collective after each sweep.  ``L``
    is the strictly lower coupling matrix in the accumulation dtype (fp32
    under an fp32 or bf16 ``w``, fp64 under fp64; ``gmres_tpu/solver/
    gmres.py:209,222``), updated in place; both sweeps take w and v_k in that
    dtype, and h and w' return in w's (``gmres_tpu/ops/orth.py:159-181``).
    Rows > k of V and L are zero, so h is zero past k.  Returns (h, w',
    ||w'||^2, L)."""
    rows = k + 1
    acc = L.dtype
    wa = w.to(acc)
    # (u, l) as the columns of K2x2's one (m+1, 2) output: one collective
    u, ell = all_reduce(gram2(V, wa, V[k].to(acc), rows), comm).unbind(1)
    L[k, :k] = ell[:k]
    h = torch.linalg.solve_triangular(L, u.unsqueeze(1), upper=False,
                                      unitriangular=True).squeeze(1)
    w2, ss = update_sumsq(V, wa, h, rows)
    return h.to(w.dtype), w2.to(w.dtype), all_reduce(ss, comm), L


def cgsr(V: torch.Tensor, k: int, w: torch.Tensor, orth_steps: int = 2, comm=None):
    """CGS with re-orthogonalization (``Orthogonalization.hpp:109-136``)."""
    h, w = cgs(V, k, w, comm)
    for _ in range(orth_steps - 1):
        u, w = cgs(V, k, w, comm)
        h = h + u
    return h, w


def orthogonalize(kind: str, V, k: int, w, orth_steps: int = 2, comm=None):
    if kind == "cgs":
        return cgs(V, k, w, comm)
    if kind == "mgs":
        h, w, _ = mgs(V, k, w, comm)
        return h, w
    if kind == "cgsr":
        return cgsr(V, k, w, orth_steps, comm)
    raise ValueError(f"unknown orthogonalization {kind!r}")


def orthonormalize_step(kind: str, V, k: int, w, orth_steps: int = 2, comm=None):
    """Orthogonalize w against rows 0..k of V and take the norm of the
    result: ``(h_col, w_orth, ||w_orth||)``.  The two-pass CGSR step is
    three basis sweeps (gram, update+gram, update+sum of squares), CGS two,
    with the norm folded into the last sweep; MGS is one K7 launch with the
    norm from its sum of squares."""
    if kind == "cgsr" and orth_steps == 2:
        return cgsr2(V, w, k + 1, comm)
    if kind == "cgs":
        u = all_reduce(gram(V, w, k + 1), comm)
        w2, ss = update_sumsq(V, w, u, k + 1)
        return u, w2, torch.sqrt(all_reduce(ss, comm)).to(w.dtype)
    if kind == "mgs":
        return mgs(V, k, w, comm)
    h, w = orthogonalize(kind, V, k, w, orth_steps, comm)
    acc = acc_dtype(w.dtype)
    if acc == w.dtype:
        return h, w, nrm2(w, comm)
    wa = w.to(acc)
    return h, w, torch.sqrt(all_reduce(torch.dot(wa, wa), comm)).to(w.dtype)
