"""Sparse matrix-vector product dispatch.

DIA operators go to ``dia_spmv`` (kernel K1 on the card) and sliced-ELL
operators to ``sell_spmv`` (kernel K5 on the card).  CSR is the fallback
for a matrix both formats refuse: a plain torch gather plus ``index_add_``
over the precomputed row ids, as the JAX package leaves its CSR path to
XLA.  A double-float ``DF64Dia`` takes an fp64 x through split, kernel K8
and merge (``gmres_tpu/ops/spmv.py:66-70``).  The JAX package's ``DF64Sell``
has no counterpart: the port's fp64 SELL operator runs K5 in native fp64.

In a distributed solve (``comm`` given) a rank's block of a halo operator
goes to ``parallel/halo.py:halo_spmv`` (K12 on the card for a DIA block);
any other operator is the rank's row block with global columns, and the
operand is all-gathered first (``gmres_tpu/ops/spmv.py:gather_operand``).

``spmv_lanes`` is the batched solve's product over s lanes: one launch of
K1's lane form on a DIA operator (the bands read once for all lanes), and
lane by lane on any other.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.dia import DF64Dia, DIAMatrix, dia_spmv, dia_spmv_df64, dia_spmv_lanes
from gmres_tpu_torch.ops.eft import merge_f64, split_f64
from gmres_tpu_torch.ops.sell import SELLMatrix, sell_spmv
from gmres_tpu_torch.parallel.halo import LocalHaloCSR, LocalHaloDIA, halo_spmv
from gmres_tpu_torch.sparse import CSRMatrix


def csr_spmv(A: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_{k: row_ids[k] == i} vals[k] * x[col_idx[k]]."""
    prod = A.vals * x.to(A.vals.dtype)[A.col_idx]
    y = torch.zeros(A.n_rows, dtype=A.vals.dtype, device=A.vals.device)
    return y.index_add_(0, A.row_ids, prod)


def spmv(A, x: torch.Tensor, comm=None) -> torch.Tensor:
    """y = A @ x in A's dtype; x is cast to A's dtype first (fp64 for a
    ``DF64Dia``).  With ``comm``, this rank's rows of y from its block of
    x."""
    if isinstance(A, (LocalHaloDIA, LocalHaloCSR)):
        return halo_spmv(A, x, comm)
    if comm is not None:
        x = comm.all_gather(x)
    if isinstance(A, DIAMatrix):
        return dia_spmv(A, x)
    if isinstance(A, SELLMatrix):
        return sell_spmv(A, x)
    if isinstance(A, CSRMatrix):
        return csr_spmv(A, x)
    if isinstance(A, DF64Dia):
        return merge_f64(*dia_spmv_df64(A, *split_f64(x.to(torch.float64))))
    raise TypeError(f"spmv on {type(A).__name__}: the port takes DIA, SELL, CSR and "
                    "DF64Dia operators")


def spmv_lanes(A, X: torch.Tensor) -> torch.Tensor:
    """Y[j] = A @ X[j] for each lane of X (s, n), Y (s, n) in A's dtype,
    each lane with the bits of ``spmv(A, X[j])``: a DIA operator takes K1's
    lane form, a SELL operator K5 and a CSR one the plain route, lane by
    lane."""
    if isinstance(A, DIAMatrix):
        return dia_spmv_lanes(A, X)
    return torch.stack([spmv(A, x) for x in X])
