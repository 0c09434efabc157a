"""SELL (sliced ELL): the format for unstructured sparsity that DIA refuses.

Rows are cut into slices of 32 (one warp of kernel K5).  Slice s is as
wide as its longest row, w_s slots per row, stored column-major: slot k of
row r of the slice lies at ``slice_ptr[s] + k*32 + r``.  Columns are
absolute int32, values are in the operator's dtype, and a padding slot
holds value 0 and a valid column (its own row's index, clipped to n_cols),
so the kernel's slot loop needs no test.  Each warp step then reads 32
consecutive values and columns and gathers x from L2.

This is not the pack of ``gmres_tpu.ops.sell``: that one (128-row slabs,
W-wide column buckets with bucket-relative columns, dense blocks for the
MXU, parts sized to SMEM, a cost model fitted on v5e, a native packer)
exists because the TPU has no usable gather.  The two packs share no
arrays; they compute the same product.

``sell_from_csr`` packs on the host with vectorised numpy and sorts no
rows.  It refuses (returns None, and the CSR route runs, as in the JAX
package) only when the padding exceeds ``MAX_PADDING`` slots per stored
entry.  ``sell_spmv`` sends a CUDA operator to K5 and a CPU one to the
plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.ops.cuda.sell_kernel import SLICE, sell_spmv_cuda, sell_spmv_plain
from gmres_tpu_torch.sparse import CSRMatrix

# Slots per stored entry above which the pack is refused.  The CSR route
# (a gather plus index_add_) moves about 28 bytes per entry in fp32 (4 B
# value, 8 B int64 column, 8 B int64 row id, a product written and read
# back) and a float atomic; the sliced ELL moves 8 B per slot (4 B value,
# 4 B int32 column).  At 3 slots per entry it streams 24 B per entry, about
# what CSR streams before its atomics; past that, CSR moves fewer bytes.
MAX_PADDING = 3.0


@dataclasses.dataclass(frozen=True)
class SELLMatrix:
    """Sliced ELL with 32-row slices; see the module docstring."""

    vals: torch.Tensor       # (n_slots,) operator dtype, 0 in padding slots
    cols: torch.Tensor       # (n_slots,) int32, absolute columns
    slice_ptr: torch.Tensor  # (n_slices + 1,) int64, first slot of each slice
    n_rows: int
    n_cols: int
    nnz: int                 # stored entries of the source matrix

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_slots(self) -> int:
        return self.vals.shape[0]

    @property
    def padding(self) -> float:
        """Slots per stored entry (1.0 when no slot is padding)."""
        return self.n_slots / max(self.nnz, 1)

    def astype(self, dtype: torch.dtype) -> "SELLMatrix":
        """Dtype-staged copy; the columns and slice offsets are shared."""
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def to(self, device) -> "SELLMatrix":
        return dataclasses.replace(self, vals=self.vals.to(device),
                                   cols=self.cols.to(device),
                                   slice_ptr=self.slice_ptr.to(device))


def sell_from_csr(A: CSRMatrix, max_padding: float = MAX_PADDING) -> SELLMatrix | None:
    """CSR -> sliced ELL on the host, or None when A stores nothing, has
    more than 2^31 columns (int32 columns), or would pad past
    ``max_padding`` slots per entry.  Each row keeps its CSR entry order
    (unsorted columns and duplicates are stored as they come).  The
    result's arrays lie on the CPU."""
    n = A.n_rows
    rp, ci, v = A.numpy_arrays()
    rp = rp.astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0 or A.n_cols > 1 << 31:
        return None
    n_slices = -(-n // SLICE)
    lengths = np.zeros(n_slices * SLICE, dtype=np.int64)
    lengths[:n] = np.diff(rp)
    widths = lengths.reshape(n_slices, SLICE).max(axis=1)
    slice_ptr = np.zeros(n_slices + 1, dtype=np.int64)
    np.cumsum(widths * SLICE, out=slice_ptr[1:])
    n_slots = int(slice_ptr[-1])
    if n_slots > max_padding * nnz:
        return None

    # every slot first holds its padding: value 0, column = its row
    slot_slice = np.repeat(np.arange(n_slices, dtype=np.int64), widths * SLICE)
    pad_rows = slot_slice * SLICE + np.arange(n_slots, dtype=np.int64) % SLICE
    cols = np.minimum(pad_rows, A.n_cols - 1).astype(np.int32)
    del slot_slice, pad_rows
    vals = np.zeros(n_slots, dtype=v.dtype)
    # entry e, the k-th of row i, goes to slice_ptr[i // 32] + k*32 + i % 32
    rows = np.repeat(np.arange(n, dtype=np.int64), lengths[:n])
    k = np.arange(nnz, dtype=np.int64) - rp[rows]
    slot = slice_ptr[rows // SLICE] + k * SLICE + rows % SLICE
    cols[slot] = ci[:nnz]
    vals[slot] = v[:nnz]
    return SELLMatrix(vals=torch.from_numpy(vals), cols=torch.from_numpy(cols),
                      slice_ptr=torch.from_numpy(slice_ptr), n_rows=n,
                      n_cols=A.n_cols, nnz=nnz)


def sell_spmv(A: SELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in A's dtype (x is cast first)."""
    x = x.to(A.vals.dtype)
    fn = sell_spmv_cuda if A.vals.is_cuda else sell_spmv_plain
    return fn(A.vals, A.cols, A.slice_ptr, x, A.n_rows)
