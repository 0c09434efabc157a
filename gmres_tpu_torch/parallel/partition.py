"""1-D row partitioning of CSR matrices over the ranks of a process group.

Rank s owns a contiguous block of rows of A and the matching block of every
vector (x, b, r and each Krylov basis vector).  Rows are padded so that every
block has the same height (``gmres_tpu/parallel/partition.py``, held to it
bit for bit):

- the row count is padded to a multiple of the rank count; padded rows are
  empty and contribute zeros everywhere;
- each block's entry arrays are padded to the largest block's entry count,
  rounded up to ``pad_multiple``; padded entries have value 0 and point at
  local row ``rows_per - 1`` and global column 0.

Column indices stay global: the allgather route gathers the whole operand
and multiplies locally (``ops/spmv.py``).  The halo route is
``parallel/halo.py``.  Everything here is host numpy; ``local_block`` hands
one rank its block as a ``CSRMatrix``.  The JAX package's per-host mode
(``owned=``, ``ShardStack``) is not carried.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.sparse import CSRMatrix


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Row-partitioned CSR: host arrays stacked over a leading rank axis."""

    row_ptr: np.ndarray  # (P, rows_per+1) int32, block-local offsets
    col_idx: np.ndarray  # (P, K) int32, GLOBAL column indices
    row_ids: np.ndarray  # (P, K) int32, block-LOCAL row ids (sorted)
    vals: np.ndarray     # (P, K)
    n_shards: int
    rows_per_shard: int
    n_cols: int          # global (padded) column count
    nnz: int             # true global stored-entry count

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> "PartitionedCSR":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def local_block(self, rank: int) -> CSRMatrix:
        """Rank ``rank``'s rows as a CSRMatrix of ``rows_per_shard`` rows and
        the global padded column count (CPU tensors), the entry padding
        dropped."""
        rp = self.row_ptr[rank].astype(np.int64)
        cnt = int(rp[-1])
        return CSRMatrix(
            row_ptr=torch.from_numpy(rp),
            col_idx=torch.from_numpy(self.col_idx[rank, :cnt].astype(np.int64)),
            row_ids=torch.from_numpy(self.row_ids[rank, :cnt].astype(np.int64)),
            vals=torch.from_numpy(self.vals[rank, :cnt].copy()),
            n_rows=self.rows_per_shard,
            n_cols=self.n_cols,
            nnz=cnt,
        )


def padded_size(n: int, n_shards: int) -> int:
    return -(-n // n_shards) * n_shards


def pad_vector(v: np.ndarray, n_shards: int) -> np.ndarray:
    """Zero-pad to ``n_shards`` equal blocks."""
    n_pad = padded_size(v.shape[0], n_shards)
    if n_pad == v.shape[0]:
        return v
    out = np.zeros((n_pad,), dtype=v.dtype)
    out[: v.shape[0]] = v
    return out


def partition_rows(A: CSRMatrix, n_shards: int, pad_multiple: int = 1024) -> PartitionedCSR:
    """Split A into ``n_shards`` contiguous row blocks with identical
    shapes."""
    n = A.n_rows
    n_pad = padded_size(n, n_shards)
    rows_per = n_pad // n_shards

    rp, ci, v = A.numpy_arrays()
    rp = rp.astype(np.int64)
    nnz = int(rp[-1])
    ci = ci[:nnz]
    v = v[:nnz]

    rp_pad = np.concatenate([rp, np.full(n_pad - n, rp[-1], dtype=np.int64)])
    starts = [int(rp_pad[s * rows_per]) for s in range(n_shards)]
    ends = [int(rp_pad[(s + 1) * rows_per]) for s in range(n_shards)]
    K = max(pad_multiple, -(-max(e - s0 for s0, e in zip(starts, ends)) // pad_multiple)
            * pad_multiple)

    row_ptr = np.zeros((n_shards, rows_per + 1), dtype=np.int32)
    col_idx = np.zeros((n_shards, K), dtype=np.int32)
    row_ids = np.full((n_shards, K), rows_per - 1, dtype=np.int32)
    vals = np.zeros((n_shards, K), dtype=v.dtype)
    for s in range(n_shards):
        lo, hi = starts[s], ends[s]
        cnt = hi - lo
        block = rp_pad[s * rows_per:(s + 1) * rows_per + 1]
        row_ptr[s] = (block - lo).astype(np.int32)
        col_idx[s, :cnt] = ci[lo:hi]
        vals[s, :cnt] = v[lo:hi]
        row_ids[s, :cnt] = np.repeat(np.arange(rows_per, dtype=np.int32), np.diff(block))

    return PartitionedCSR(row_ptr=row_ptr, col_idx=col_idx, row_ids=row_ids, vals=vals,
                          n_shards=n_shards, rows_per_shard=rows_per, n_cols=n_pad, nnz=nnz)
