"""Halo-exchange distributed SpMV.

The allgather route (``ops/spmv.py``) moves (P-1)/P of the operand to every
rank for each SpMV.  A row block of a banded matrix needs only two edges of
x from its neighbours: the last ``halo_left`` values of rank s-1 and the
first ``halo_right`` of rank s+1 (``comm.exchange_halos``).  A row block of
a DIA matrix is a column slice of its bands with unchanged offsets, so the
local product stays a shifted multiply-add pass over the edges and the
block (kernel K12 on the card, ``ops/cuda/halo_kernel.py``).  A rebased CSR
covers patterns that are neighbour-local but not banded enough for DIA.

``partition_halo`` is the global branch of ``gmres_tpu/parallel/halo.py:
partition_halo`` in host numpy, bit for bit; its per-host branch
(``owned=``) is not carried.  The partitions hold every rank's block;
``local(rank)`` hands one rank its own as tensors.

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
from gmres_tpu_torch.parallel.partition import padded_size, partition_rows
from gmres_tpu_torch.sparse import CSRMatrix


@dataclasses.dataclass(frozen=True)
class HaloDIA:
    """Row-partitioned DIA: every rank's bands, stacked (host numpy)."""

    data: np.ndarray             # (P, D, rows_per)
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


def partition_halo(A: CSRMatrix, n_shards: int):
    """Partition A for halo exchange: a ``HaloDIA`` when DIA takes the
    pattern, else a ``HaloCSR`` when every column stays within one
    neighbour's rows, else None (the allgather route)."""
    n = A.n_rows
    n_pad = padded_size(n, n_shards)
    r = n_pad // n_shards

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
