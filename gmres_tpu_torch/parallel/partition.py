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
one rank its block as a ``CSRMatrix``.

Per-host mode (``owned=``): only the owned blocks' arrays are built, held
in a ``ShardStack`` (the global stacked shape and the owned pieces), so a
rank materializes ~1/P of the partition; the metadata comes from the global
``row_ptr``, which every rank has.  A rank of the port owns the block of
its own rank.  ``A`` may then be a per-host ``RowBlockCSR`` whose loaded
rows cover the owned blocks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.sparse import CSRMatrix, RowBlockCSR


@dataclasses.dataclass
class ShardStack:
    """A ``(P, ...)``-stacked host array of which only the owned shards
    exist: ``pieces[s]`` is shard s without the leading axis; ``shape`` is
    the global stacked shape."""

    shape: tuple
    dtype: np.dtype
    pieces: dict

    def astype(self, dtype) -> "ShardStack":
        dt = np.dtype(dtype)
        if dt == self.dtype:
            return self
        return ShardStack(self.shape, dt, {s: p.astype(dt) for s, p in self.pieces.items()})

    def __getitem__(self, s: int) -> np.ndarray:
        if isinstance(s, tuple):
            return self.pieces[s[0]][s[1:]]
        return self.pieces[s]

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pieces.values())


def stack_pieces(pieces: dict, shape: tuple, dtype, owned) -> np.ndarray | ShardStack:
    """The shards' pieces as a stacked array, or a ``ShardStack`` of the
    owned ones in per-host mode."""
    if owned is not None:
        return ShardStack(tuple(shape), np.dtype(dtype), pieces)
    return np.stack([pieces[s] for s in range(shape[0])])


def local_partition_nbytes(*objs) -> int:
    """Host bytes of the partitioned forms in ``objs`` (dataclasses, tuples
    and lists walked): a ``ShardStack`` counts its owned pieces, an array
    or a tensor in full."""
    total = 0

    def walk(o):
        nonlocal total
        if isinstance(o, (ShardStack, np.ndarray)):
            total += o.nbytes
        elif isinstance(o, torch.Tensor):
            total += o.nelement() * o.element_size()
        elif isinstance(o, (tuple, list)):
            for e in o:
                walk(e)
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))

    for o in objs:
        walk(o)
    return total


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """Row-partitioned CSR: host arrays stacked over a leading rank axis."""

    row_ptr: np.ndarray  # (P, rows_per+1) int32, block-local offsets
    col_idx: np.ndarray  # (P, K) int32, GLOBAL column indices
    row_ids: np.ndarray  # (P, K) int32, block-LOCAL row ids (sorted)
    vals: np.ndarray     # (P, K); each a ShardStack in per-host mode
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


def pad_vector(v: np.ndarray, n_shards: int, rows_per: int | None = None) -> np.ndarray:
    """Zero-pad to ``n_shards`` equal blocks (of ``rows_per`` rows when
    given: the SELL route's grid, ``parallel/dist_gmres.py``)."""
    n_pad = rows_per * n_shards if rows_per is not None else padded_size(v.shape[0], n_shards)
    if n_pad == v.shape[0]:
        return v
    out = np.zeros((n_pad,), dtype=v.dtype)
    out[: v.shape[0]] = v
    return out


def host_arrays(A):
    """(row_ptr int64, col_idx, vals) of a CSRMatrix as host numpy, or
    (row_ptr, None, None) for a RowBlockCSR, whose entries come from
    ``A.entries``."""
    if isinstance(A, RowBlockCSR):
        return np.asarray(A.row_ptr).astype(np.int64), None, None
    rp, ci, v = A.numpy_arrays()
    rp = rp.astype(np.int64)
    return rp, ci[:rp[-1]], v[:rp[-1]]


def partition_rows(A, n_shards: int, pad_multiple: int = 1024, rows_per: int | None = None,
                   owned=None) -> PartitionedCSR:
    """Split A into ``n_shards`` contiguous row blocks with identical
    shapes.  ``rows_per`` sets the block height (at least ceil(n/P)), so
    that pieces of a solve agree on their shapes; ``owned`` builds only
    those blocks (per-host mode, ``ShardStack`` leaves).  ``A`` is a
    ``CSRMatrix`` or a ``RowBlockCSR`` covering the owned blocks."""
    n = A.n_rows
    if rows_per is not None:
        if rows_per * n_shards < n:
            raise ValueError(f"{n_shards} blocks of {rows_per} rows do not cover {n}")
        n_pad = rows_per * n_shards
    else:
        n_pad = padded_size(n, n_shards)
        rows_per = n_pad // n_shards

    rp, ci, v = host_arrays(A)
    nnz = int(rp[-1])
    vdtype = A.vals.dtype if isinstance(A, RowBlockCSR) else v.dtype

    rp_pad = np.concatenate([rp, np.full(n_pad - n, rp[-1], dtype=np.int64)])
    starts = [int(rp_pad[s * rows_per]) for s in range(n_shards)]
    ends = [int(rp_pad[(s + 1) * rows_per]) for s in range(n_shards)]
    K = max(pad_multiple, -(-max(e - s0 for s0, e in zip(starts, ends)) // pad_multiple)
            * pad_multiple)

    pieces = {k: {} for k in ("rp", "ci", "rid", "v")}
    for s in (sorted(owned) if owned is not None else range(n_shards)):
        lo, hi = starts[s], ends[s]
        cnt = hi - lo
        block = rp_pad[s * rows_per:(s + 1) * rows_per + 1]
        col_s = np.zeros(K, dtype=np.int32)
        rid_s = np.full(K, rows_per - 1, dtype=np.int32)
        val_s = np.zeros(K, dtype=vdtype)
        if isinstance(A, RowBlockCSR):
            ci_s, v_s = A.entries(min(s * rows_per, n), min((s + 1) * rows_per, n))
            col_s[:cnt], val_s[:cnt] = ci_s, v_s
        else:
            col_s[:cnt], val_s[:cnt] = ci[lo:hi], v[lo:hi]
        rid_s[:cnt] = np.repeat(np.arange(rows_per, dtype=np.int32), np.diff(block))
        pieces["rp"][s] = (block - lo).astype(np.int32)
        pieces["ci"][s], pieces["rid"][s], pieces["v"][s] = col_s, rid_s, val_s

    return PartitionedCSR(
        row_ptr=stack_pieces(pieces["rp"], (n_shards, rows_per + 1), np.int32, owned),
        col_idx=stack_pieces(pieces["ci"], (n_shards, K), np.int32, owned),
        row_ids=stack_pieces(pieces["rid"], (n_shards, K), np.int32, owned),
        vals=stack_pieces(pieces["v"], (n_shards, K), vdtype, owned),
        n_shards=n_shards, rows_per_shard=rows_per, n_cols=n_pad, nnz=nnz)
