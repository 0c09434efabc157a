"""Halo-exchange distributed SpMV.

The allgather route (``ops/spmv.py``) moves (P-1)/P of the operand to every
rank for each SpMV.  A row block of a banded matrix needs only two edges of
x from its neighbours: the last ``halo_left`` values of rank s-1 and the
first ``halo_right`` of rank s+1 (``comm.exchange_halos``).  A row block of
a DIA matrix is a column slice of its bands with unchanged offsets, so the
local product stays a shifted multiply-add pass over the edges and the
block (kernel K12 on the card, ``ops/cuda/halo_kernel.py``).  A rebased CSR
covers patterns that are neighbour-local but not banded enough for DIA.

``partition_halo`` is ``gmres_tpu/parallel/halo.py:partition_halo`` in host
numpy, bit for bit.  The global branch holds every rank's block; the
per-host branch (``owned=``, or a ``RowBlockCSR`` input) builds only the
owned blocks (``ShardStack``) from range-at-a-time scans, and combines the
ranks' metadata partials (diagonal offsets, halo widths) through
``exchange`` (``parallel/multihost.py:exchange_host_array``), every rank
calling it alike.  ``rowblock_dia_gate`` is the ranks' vote on whether DIA
takes the global pattern.  ``local(rank)`` hands one rank its own block as
tensors.

Restriction (checked at partition time): each halo fits within the
immediate neighbour (halo <= rows per rank), else the allgather route.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.ops.cuda.halo_kernel import (
    dia_residual_halo_cuda,
    dia_residual_halo_plain,
    dia_spmv_halo_cuda,
    dia_spmv_halo_plain,
)
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.parallel.multihost import pack_offsets, union_offsets
from gmres_tpu_torch.parallel.partition import (
    ShardStack,
    host_arrays,
    padded_size,
    partition_rows,
)
from gmres_tpu_torch.sparse import RowBlockCSR


@dataclasses.dataclass(frozen=True)
class HaloDIA:
    """Row-partitioned DIA: every rank's bands, stacked (host numpy)."""

    data: np.ndarray             # (P, D, rows_per); a ShardStack in per-host mode
    offsets: tuple[int, ...]     # global diagonal offsets
    n_shards: int
    rows_per_shard: int
    halo_left: int
    halo_right: int
    nnz: int

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "HaloDIA":
        return dataclasses.replace(self, data=self.data.astype(dtype))

    def local(self, rank: int) -> "LocalHaloDIA":
        return LocalHaloDIA(data=torch.from_numpy(self.data[rank].copy()),
                            offsets=self.offsets, rows_per_shard=self.rows_per_shard,
                            halo_left=self.halo_left, halo_right=self.halo_right)


@dataclasses.dataclass(frozen=True)
class HaloCSR:
    """Row-partitioned CSR with columns rebased into the haloed window
    ``[s*r - halo_left, (s+1)*r + halo_right)`` (host numpy)."""

    row_ptr: np.ndarray  # (P, rows_per+1)
    col_idx: np.ndarray  # (P, K), window-local indices
    row_ids: np.ndarray  # (P, K)
    vals: np.ndarray     # (P, K)
    n_shards: int
    rows_per_shard: int
    halo_left: int
    halo_right: int
    nnz: int

    @property
    def dtype(self):
        return self.vals.dtype

    def astype(self, dtype) -> "HaloCSR":
        return dataclasses.replace(self, vals=self.vals.astype(dtype))

    def local(self, rank: int) -> "LocalHaloCSR":
        cnt = int(self.row_ptr[rank, -1])
        return LocalHaloCSR(
            col_idx=torch.from_numpy(self.col_idx[rank, :cnt].astype(np.int64)),
            row_ids=torch.from_numpy(self.row_ids[rank, :cnt].astype(np.int64)),
            vals=torch.from_numpy(self.vals[rank, :cnt].copy()),
            rows_per_shard=self.rows_per_shard, halo_left=self.halo_left,
            halo_right=self.halo_right)


@dataclasses.dataclass(frozen=True)
class LocalHaloDIA:
    """One rank's block of a ``HaloDIA``: its (D, rows_per) bands."""

    data: torch.Tensor
    offsets: tuple[int, ...]
    rows_per_shard: int
    halo_left: int
    halo_right: int

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def astype(self, dtype: torch.dtype) -> "LocalHaloDIA":
        return dataclasses.replace(self, data=self.data.to(dtype))

    def to(self, device) -> "LocalHaloDIA":
        return dataclasses.replace(self, data=self.data.to(device))


@dataclasses.dataclass(frozen=True)
class LocalHaloCSR:
    """One rank's block of a ``HaloCSR`` (entry padding dropped)."""

    col_idx: torch.Tensor  # window-local
    row_ids: torch.Tensor
    vals: torch.Tensor
    rows_per_shard: int
    halo_left: int
    halo_right: int

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def astype(self, dtype: torch.dtype) -> "LocalHaloCSR":
        return dataclasses.replace(self, vals=self.vals.to(dtype))

    def to(self, device) -> "LocalHaloCSR":
        return dataclasses.replace(self, col_idx=self.col_idx.to(device),
                                   row_ids=self.row_ids.to(device), vals=self.vals.to(device))


def _round_up(v: int, mult: int = 128) -> int:
    return max(mult, -(-v // mult) * mult)


def partition_halo(A, n_shards: int, owned=None, exchange=None):
    """Partition A for halo exchange: a ``HaloDIA`` when DIA takes the
    pattern, else a ``HaloCSR`` when every column stays within one
    neighbour's rows, else None (the allgather route).  ``owned`` or a
    ``RowBlockCSR`` takes the per-host branch (see the module docstring;
    ``exchange=None`` there treats the local partials as global)."""
    n = A.n_rows
    n_pad = padded_size(n, n_shards)
    r = n_pad // n_shards
    if owned is not None or isinstance(A, RowBlockCSR):
        return _partition_halo_owned(A, n_shards, range(n_shards) if owned is None else owned,
                                     r, exchange)

    dia = from_csr(A)
    if dia is not None:
        hl = max(0, -min(dia.offsets))
        hr = max(0, max(dia.offsets))
        if hl <= r and hr <= r:
            data = dia.data.numpy()
            if n_pad != n:
                data = np.concatenate(
                    [data, np.zeros((data.shape[0], n_pad - n), data.dtype)], axis=1)
            D = data.shape[0]
            return HaloDIA(
                data=data.reshape(D, n_shards, r).transpose(1, 0, 2).copy(),
                offsets=dia.offsets,
                n_shards=n_shards,
                rows_per_shard=r,
                halo_left=min(_round_up(hl), r) if hl else 0,
                halo_right=min(_round_up(hr), r) if hr else 0,
                nnz=A.nnz,
            )

    part = partition_rows(A, n_shards)
    base = np.arange(n_shards, dtype=np.int64)[:, None] * r
    rel = part.col_idx.astype(np.int64) - base  # column relative to the block start
    active = part.vals != 0
    if not active.any():
        return None
    hl = int(np.maximum(0, -(rel[active].min())))
    hr = int(np.maximum(0, rel[active].max() - (r - 1)))
    if hl > r or hr > r:
        return None
    hl = min(_round_up(hl), r) if hl else 0
    hr = min(_round_up(hr), r) if hr else 0
    rebased = (rel + hl).astype(np.int32)
    rebased[~active] = 0  # padding entries point anywhere in the window
    return HaloCSR(row_ptr=part.row_ptr, col_idx=rebased, row_ids=part.row_ids,
                   vals=part.vals, n_shards=n_shards, rows_per_shard=r, halo_left=hl,
                   halo_right=hr, nnz=A.nnz)


_MAX_DIAGS = 256  # from_csr's diagonal-count gate


def _unique_offsets(ci: np.ndarray, rp: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The distinct (column - row) offsets of rows [lo, hi), by a presence
    bitmap over their range (no sort of the entries)."""
    offs = ci.astype(np.int64) - np.repeat(np.arange(lo, hi, dtype=np.int64),
                                           np.diff(rp[lo:hi + 1]))
    if not offs.shape[0]:
        return np.zeros(0, dtype=np.int64)
    off_min = int(offs.min())
    present = np.zeros(int(offs.max()) - off_min + 1, dtype=bool)
    present[offs - off_min] = True
    return np.flatnonzero(present) + off_min


def rowblock_dia_gate(A, exchange=None, max_fill: float = 3.0,
                      max_diags: int = _MAX_DIAGS) -> bool:
    """Whether ``ops/dia.py:from_csr``'s gates (the distinct-diagonal count
    and the fill) take the GLOBAL pattern, voted by the ranks
    (``gmres_tpu/parallel/halo.py:rowblock_dia_gate``): each scans its
    loaded rows (a ``RowBlockCSR``; overlapping blocks are fine, offsets
    combine as a set union) and the partials meet in one ``exchange``
    round, so every rank reads the same verdict.  ``exchange=None`` takes
    the local scan as global."""
    n = A.n_rows
    rp = np.asarray(A.row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if isinstance(A, RowBlockCSR):
        lo, hi = A.row_lo, A.row_hi
        ci, _ = A.entries(lo, hi)
    else:
        lo, hi = 0, n
        ci = host_arrays(A)[1]
    uniq = _unique_offsets(ci, rp, lo, hi)
    overflow = uniq.shape[0] > max_diags
    if exchange is not None:
        # every rank calls exchange once, an overflowed one too (count -1)
        payload = pack_offsets(range(max_diags + 1) if overflow else [int(o) for o in uniq],
                               max_diags)
        union = union_offsets(np.asarray(exchange(payload)), max_diags)
        if union is None:
            return False
        D = len(union)
    else:
        if overflow:
            return False
        D = uniq.shape[0]
    if nnz == 0:
        return False
    return D <= max_diags and D * n <= max_fill * nnz


def _partition_halo_owned(A, n_shards: int, owned, r: int, exchange=None):
    """The per-host ``partition_halo`` (``gmres_tpu/parallel/halo.py:
    _partition_halo_owned``): the global branch's gates and results, with
    values built only for the owned blocks and every metadata pass over one
    block's rows at a time.  A ``RowBlockCSR`` scans only its owned blocks
    and combines the partials through ``exchange``."""
    owned = sorted(set(owned))
    n = A.n_rows
    rp, ci, v = host_arrays(A)
    nnz = int(rp[-1])
    if nnz == 0:
        return None
    is_block = isinstance(A, RowBlockCSR)
    vdtype = A.vals.dtype if is_block else v.dtype

    def ranges(scan_owned: bool):
        for s in (owned if scan_owned else range(n_shards)):
            lo, hi = s * r, min((s + 1) * r, n)
            if hi > lo and rp[hi] > rp[lo]:
                yield s, lo, hi, int(rp[lo]), int(rp[hi])

    def entries(lo, hi, a, b):
        return A.entries(lo, hi) if is_block else (ci[a:b], v[a:b])

    # the distinct diagonal offsets, a block at a time; a local count past
    # the gate is clipped (the global count can only be larger)
    local_offs, overflow = set(), False
    for s, lo, hi, a, b in ranges(scan_owned=is_block):
        local_offs.update(int(o) for o in _unique_offsets(entries(lo, hi, a, b)[0], rp, lo, hi))
        if len(local_offs) > _MAX_DIAGS:
            overflow = True
            break
    if is_block and exchange is not None:
        payload = pack_offsets(range(_MAX_DIAGS + 1) if overflow else local_offs, _MAX_DIAGS)
        union = union_offsets(np.asarray(exchange(payload)), _MAX_DIAGS)
        overflow = union is None
        if not overflow:
            local_offs = union
    uniq = np.array(sorted(local_offs), dtype=np.int64)
    D = uniq.shape[0] if not overflow else _MAX_DIAGS + 1
    if D == 0:
        return None
    if D <= _MAX_DIAGS and D * n <= 3.0 * max(nnz, 1):
        off_min = int(uniq.min())
        hl, hr = max(0, -off_min), max(0, int(uniq.max()))
        if hl <= r and hr <= r:
            lookup = np.zeros(int(uniq.max()) - off_min + 1, dtype=np.int64)
            lookup[uniq - off_min] = np.arange(D)
            by_shard = {s: (lo, hi, a, b) for s, lo, hi, a, b in ranges(scan_owned=True)}
            pieces = {}
            for s in owned:
                if s not in by_shard:
                    pieces[s] = np.zeros((D, r), dtype=vdtype)
                    continue
                lo, hi, a, b = by_shard[s]
                rows_s = np.repeat(np.arange(lo, hi, dtype=np.int64), np.diff(rp[lo:hi + 1]))
                ci_s, v_s = entries(lo, hi, a, b)
                d_idx = lookup[ci_s.astype(np.int64) - rows_s - off_min]
                pieces[s] = np.bincount(d_idx * r + (rows_s - lo), weights=v_s,
                                        minlength=D * r).reshape(D, r).astype(vdtype)
            return HaloDIA(data=ShardStack((n_shards, D, r), np.dtype(vdtype), pieces),
                           offsets=tuple(int(o) for o in uniq), n_shards=n_shards,
                           rows_per_shard=r,
                           halo_left=min(_round_up(hl), r) if hl else 0,
                           halo_right=min(_round_up(hr), r) if hr else 0, nnz=nnz)

    # irregular: a rebased CSR when every column stays within a neighbour
    hl = hr = 0
    any_active = False
    for s, lo, hi, a, b in ranges(scan_owned=is_block):
        ci_s, v_s = entries(lo, hi, a, b)
        active = v_s != 0
        if not active.any():
            continue
        any_active = True
        rel = ci_s.astype(np.int64)[active] - s * r
        hl = max(hl, int(np.maximum(0, -rel.min())))
        hr = max(hr, int(np.maximum(0, rel.max() - (r - 1))))
    if is_block and exchange is not None:
        g = np.asarray(exchange(np.array([hl, hr, int(any_active)], dtype=np.int64)))
        hl, hr, any_active = int(g[:, 0].max()), int(g[:, 1].max()), bool(g[:, 2].any())
    if not any_active or hl > r or hr > r:
        return None
    hl = min(_round_up(hl), r) if hl else 0
    hr = min(_round_up(hr), r) if hr else 0
    part = partition_rows(A, n_shards, owned=owned)
    col_pieces = {}
    for s in owned:
        rebased = (part.col_idx.pieces[s].astype(np.int64) - s * r + hl).astype(np.int32)
        rebased[part.vals.pieces[s] == 0] = 0
        col_pieces[s] = rebased
    return HaloCSR(row_ptr=part.row_ptr,
                   col_idx=ShardStack(part.col_idx.shape, np.dtype(np.int32), col_pieces),
                   row_ids=part.row_ids, vals=part.vals, n_shards=n_shards, rows_per_shard=r,
                   halo_left=hl, halo_right=hr, nnz=nnz)


def halo_spmv(A, x_local: torch.Tensor, comm) -> torch.Tensor:
    """This rank's rows of y = A x: the edges of x from the neighbours
    (``comm.exchange_halos``), then the local product (K12 on the card for
    an fp32 or fp64 ``LocalHaloDIA``; plain torch for a bf16 one, the JAX
    package's XLA formula, as the single-device bf16 DIA route runs; a
    gather and ``index_add_`` for a ``LocalHaloCSR``, as the JAX package
    leaves it to XLA)."""
    hl, hr = A.halo_left, A.halo_right
    x_local = x_local.to(A.dtype)
    left, right = comm.exchange_halos(x_local, hl, hr)
    if isinstance(A, LocalHaloDIA):
        fn = (dia_spmv_halo_cuda if A.data.is_cuda and A.dtype != torch.bfloat16
              else dia_spmv_halo_plain)
        return fn(A.data, A.offsets, x_local, left, right)
    if isinstance(A, LocalHaloCSR):
        xx = torch.cat([left, x_local, right])
        y = torch.zeros(A.rows_per_shard, dtype=A.dtype, device=A.vals.device)
        return y.index_add_(0, A.row_ids, A.vals * xx[A.col_idx])
    raise TypeError(f"not a halo operator: {type(A).__name__}")


def halo_residual(A: LocalHaloDIA, b: torch.Tensor, x: torch.Tensor,
                  inner_dtype: torch.dtype, comm):
    """This rank's rows of r = b - A x with the rank's shares of ||r'||^2
    and ||x||^2 (K12 residual mode on the card)."""
    left, right = comm.exchange_halos(x, A.halo_left, A.halo_right)
    fn = dia_residual_halo_cuda if A.data.is_cuda else dia_residual_halo_plain
    return fn(A.data, A.offsets, b, x, left, right, inner_dtype)
