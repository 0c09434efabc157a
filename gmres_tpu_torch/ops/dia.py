"""DIA (diagonal) sparse format: the fast path for banded matrices.

For matrices whose nonzeros lie on a bounded set of diagonals (stencil
Laplacians, convection-diffusion, most reordered PDE matrices) SpMV is

    y = sum_d  data[d] * shift(x, offset_d)

with no indexed memory access.  ``from_csr`` decides profitability on the
host, with the same gates as ``gmres_tpu.ops.dia.from_csr``: DIA stores
D*n values against CSR's nnz.

``dia_spmv`` sends a CUDA tensor to kernel K1 (``csrc/dia_spmv.cu``) in
fp32 and fp64 at every size, and a CPU tensor to the plain version; a bf16
operator runs plain torch ops on either device.  ``dia_spmv_lanes`` does the
same for the lanes of a batched solve, on K1's lane form.
``DF64Dia`` is the df64 tier's view of an fp64 DIA matrix as (hi, lo) fp32
band pairs; ``dia_spmv_df64`` sends it to kernel K8 (``csrc/df64_spmv.cu``)
on the card and to K8's plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.ops.cuda.df64_spmv_kernel import dia_spmv_df64_cuda, dia_spmv_df64_plain
from gmres_tpu_torch.ops.cuda.spmv_kernel import (
    dia_spmv_cuda,
    dia_spmv_lanes_cuda,
    dia_spmv_lanes_plain,
    dia_spmv_plain,
)
from gmres_tpu_torch.ops.eft import merge_f64, split_f64
from gmres_tpu_torch.sparse import CSRMatrix


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """``data[d, i] = A[i, i + offsets[d]]`` (0 where out of range or not
    stored); ``offsets`` is a static tuple, ascending."""

    data: torch.Tensor           # (n_diags, n_rows)
    offsets: tuple[int, ...]
    n_rows: int
    n_cols: int
    nnz: int                     # stored-entry count of the source matrix

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def vals(self) -> torch.Tensor:
        """Values view for the Frobenius norm (the padding is 0)."""
        return self.data.reshape(-1)

    def astype(self, dtype: torch.dtype) -> "DIAMatrix":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def to(self, device) -> "DIAMatrix":
        return dataclasses.replace(self, data=self.data.to(device))

    def to_dense(self) -> np.ndarray:
        data = self.data.cpu().numpy()
        out = np.zeros(self.shape, dtype=data.dtype)
        for d, off in enumerate(self.offsets):
            for i in range(max(0, -off), min(self.n_rows, self.n_cols - off)):
                out[i, i + off] = data[d, i]
        return out


def from_csr(A: CSRMatrix, max_fill: float = 3.0, max_diags: int = 256) -> DIAMatrix | None:
    """CSR -> DIA on the host when profitable, else None: the number of
    distinct diagonals D must satisfy ``D * n <= max_fill * nnz`` and
    ``D <= max_diags``.  The result's data lies on the CPU."""
    n = A.n_rows
    rp, ci = (a.cpu().numpy() for a in (A.row_ptr, A.col_idx))
    nnz = int(rp[-1])
    if nnz == 0:
        return None
    ci = ci[:nnz].astype(np.int64)
    # the values in fp64 (exact for every dtype, bf16 included, which numpy
    # lacks), the bands rounded back to A's dtype
    v = A.vals[:nnz].cpu().double().numpy()
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp.astype(np.int64)))

    offs = ci - rows
    # bounded-range unique via a presence bitmap: O(nnz + n), no sort
    off_min = int(offs.min())
    off_max = int(offs.max())
    span = off_max - off_min + 1
    present = np.zeros(span, dtype=bool)
    present[offs - off_min] = True
    uniq = np.flatnonzero(present) + off_min
    D = uniq.shape[0]
    if D > max_diags or D * n > max_fill * max(nnz, 1):
        return None

    lookup = np.zeros(span, dtype=np.int64)
    lookup[uniq - off_min] = np.arange(D)
    d_idx = lookup[offs - off_min]
    # duplicates on the same (row, col) sum, like SpMV over duplicate entries
    data = np.bincount(d_idx * n + rows, weights=v, minlength=D * n).reshape(D, n)
    return DIAMatrix(
        data=torch.from_numpy(data).to(A.vals.dtype),
        offsets=tuple(int(o) for o in uniq),
        n_rows=n,
        n_cols=A.n_cols,
        nnz=nnz,
    )


def dia_transpose(A: DIAMatrix) -> DIAMatrix:
    """A^T in DIA form (``gmres_tpu/ops/dia.py:124``): offsets negate and
    each band shifts by its own offset, ``B[-o][p] = A[o][p - o]`` (0
    outside), bands in ascending offset order.  On A's device; condest's
    Golub-Kahan recurrence takes A^T x as a second DIA product."""
    n = A.n_rows
    out = torch.zeros_like(A.data)
    for d, off in enumerate(A.offsets):
        if off >= 0:
            out[d, off:] = A.data[d, :n - off]
        else:
            out[d, :n + off] = A.data[d, -off:]
    new_offsets = [-o for o in A.offsets]
    order = sorted(range(len(new_offsets)), key=new_offsets.__getitem__)
    return DIAMatrix(data=out[order], offsets=tuple(new_offsets[i] for i in order),
                     n_rows=A.n_cols, n_cols=A.n_rows, nnz=A.nnz)


def dia_spmv(A: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in A's dtype (x is cast first).  A bf16 operator (the bf16
    inner tier) takes plain torch ops on either device, the JAX package's
    XLA formula ``y = y + data[d] * shift(x)`` with every product and sum
    rounded to bf16 (``gmres_tpu/ops/dia.py:175-205``: bf16 DIA stays on
    XLA there); K1 has no bf16 form."""
    x = x.to(A.data.dtype)
    if A.data.dtype == torch.bfloat16:
        return dia_spmv_plain(A.data, A.offsets, x)
    if A.data.is_cuda:
        return dia_spmv_cuda(A.data, A.offsets, x)
    return dia_spmv_plain(A.data, A.offsets, x)


def dia_spmv_lanes(A: DIAMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y[j] = A @ X[j] for the lanes of X (s, n_cols), in A's dtype (X is
    cast first; a view of the lanes at any stride is read in place when it
    is in A's dtype).  A bf16 operator takes ``dia_spmv``'s torch formula
    over all lanes at once."""
    X = X.to(A.data.dtype)
    if A.data.is_cuda and A.data.dtype != torch.bfloat16:
        return dia_spmv_lanes_cuda(A.data, A.offsets, X)
    return dia_spmv_lanes_plain(A.data, A.offsets, X)


@dataclasses.dataclass(frozen=True)
class DF64Dia:
    """A DIA matrix of fp64 values split into (hi, lo) fp32 band pairs
    (``gmres_tpu/ops/pallas/df64_kernel.py:316-348``): the df64 tier's inner
    operator."""

    data_hi: torch.Tensor        # (n_diags, n_rows) fp32
    data_lo: torch.Tensor
    offsets: tuple[int, ...]
    n_rows: int
    n_cols: int
    nnz: int

    @staticmethod
    def from_dia(A: DIAMatrix) -> "DF64Dia":
        dh, dl = split_f64(A.data.to(torch.float64))
        return DF64Dia(data_hi=dh, data_lo=dl, offsets=A.offsets, n_rows=A.n_rows,
                       n_cols=A.n_cols, nnz=A.nnz)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.data_hi.device

    @property
    def vals(self) -> torch.Tensor:
        """The fp64 values (hi + lo), so that ||A||_F is the fp64 matrix's."""
        return merge_f64(self.data_hi, self.data_lo).reshape(-1)

    def to(self, device) -> "DF64Dia":
        return dataclasses.replace(self, data_hi=self.data_hi.to(device),
                                   data_lo=self.data_lo.to(device))


def dia_spmv_df64(A: DF64Dia, xh: torch.Tensor, xl: torch.Tensor):
    """(yh, yl) = A @ (xh, xl) in pair arithmetic."""
    fn = dia_spmv_df64_cuda if A.data_hi.is_cuda else dia_spmv_df64_plain
    return fn(A.data_hi, A.data_lo, A.offsets, xh, xl)
