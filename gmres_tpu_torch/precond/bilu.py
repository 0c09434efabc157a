"""Block-Jacobi ILU(0), the distributed ILU preconditioner
(``gmres_tpu/precond/bilu.py``).

Global ILU(0) is a sequential pass over the whole matrix, which no rank can
run when it holds only its own rows (``RowBlockCSR``), and its factors
couple the ranks, so every sweep of its apply would need a halo or an
allgather.  Block-Jacobi ILU instead factors each rank's diagonal block
``A[s*r:(s+1)*r, s*r:(s+1)*r]`` alone: the preconditioner is block
diagonal, so its sweeps need no collective (``ILUJacobiPrec.block_local``),
and the factorization and its memory divide by P.  The couplings between
blocks are dropped from M (not from A); with one rank it is
``precond="ilu_jacobi"``.

The factors are computed in fp64 by the port's ``precond/ilu0.py`` and
rounded to the preconditioner dtype, as ``build_ilu_jacobi`` does.  They
take the JAX package's two forms, chosen by the same vote over the ranks:

- ``BlockILUDia``: every block's factor bands on the union of the blocks'
  offsets, when the union passes the DIA gates.  A rank's bands sweep on
  kernel K1 (plain torch for bf16 bands, as a bf16 DIA operator does);
- ``BlockILUCSR``: each block's triangles as padded CSR with block-local
  columns.  A rank's fp32 or fp64 triangles are then packed into the
  port's sliced ELL, as the single card packs factors DIA refuses
  (``precond/build.py:sell_pack_factors``), and sweep on K5; bf16 ones stay
  CSR (plain torch).

numpy has no bf16, so the host arrays hold the dtype's values as fp64 and
``localize_bilu`` rounds them on the way to the rank's tensors.  In
per-host mode (``owned=``) only the owned blocks are factored and held
(``ShardStack``); the metadata (offset unions, entry counts, padding
widths) meets in one ``exchange`` round that every rank calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.parallel.multihost import pack_offsets, union_offsets
from gmres_tpu_torch.parallel.partition import host_arrays, stack_pieces
from gmres_tpu_torch.precond.build import ILUJacobiPrec, sell_pack_factors
from gmres_tpu_torch.precond.ilu0 import ilu0_factorize
from gmres_tpu_torch.sparse import RowBlockCSR, csr_from_arrays

_MAXD = 256  # the diagonal-count gate of ops/dia.py:from_csr


@dataclasses.dataclass(frozen=True)
class BlockILUDia:
    """Every block's factors on shared offsets: ``lower`` (P, D_l, r) the
    strictly-lower bands (unit diagonal implied), ``upper`` (P, D_u, r) the
    upper bands with the diagonal, ``inv_diag`` (P, r); host fp64 arrays
    (or ``ShardStack``s) holding ``dtype``'s values."""

    lower: np.ndarray
    upper: np.ndarray
    inv_diag: np.ndarray
    offsets_l: tuple
    offsets_u: tuple
    steps: int
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class BlockILUCSR:
    """Every block's triangles as padded CSR stacks with block-local
    columns (``gmres_tpu/parallel/partition.py``'s padding: value 0, column
    0, row r-1)."""

    l_ptr: np.ndarray  # (P, r+1)
    l_col: np.ndarray  # (P, K_l)
    l_rid: np.ndarray  # (P, K_l)
    l_val: np.ndarray  # (P, K_l)
    u_ptr: np.ndarray
    u_col: np.ndarray
    u_rid: np.ndarray
    u_val: np.ndarray
    inv_diag: np.ndarray  # (P, r)
    steps: int
    rows_per: int
    dtype: torch.dtype


def _rounded(values: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(np.asarray(values, dtype=np.float64)).to(dtype).double().numpy()


@dataclasses.dataclass(frozen=True)
class _Tri:
    """A block triangle in CSR with block-local columns (host numpy)."""

    row_ptr: np.ndarray
    col_idx: np.ndarray
    vals: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])


def _triangles(rp: np.ndarray, ci: np.ndarray, fvals: np.ndarray, diag: np.ndarray,
               dtype: torch.dtype):
    """(strictly-lower, upper with the diagonal, inverse diagonal) of the
    combined factor ``fvals`` (fp64 values already rounded to ``dtype``);
    the inverse diagonal is taken in fp64 and rounded."""
    n = rp.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    lower_mask = np.arange(int(rp[-1]), dtype=np.int64) < diag[row_ids]

    def build(mask):
        rptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(row_ids[mask], minlength=n), out=rptr[1:])
        return _Tri(rptr, ci[mask].astype(np.int32), fvals[mask])

    return build(lower_mask), build(~lower_mask), _rounded(1.0 / fvals[diag], dtype)


def _tri_offsets(tri: _Tri) -> set:
    """The distinct (column - row) offsets of a block triangle."""
    if tri.nnz == 0:
        return set()
    rows = np.repeat(np.arange(tri.row_ptr.shape[0] - 1, dtype=np.int64),
                     np.diff(tri.row_ptr))
    offs = tri.col_idx.astype(np.int64) - rows
    off_min = int(offs.min())
    present = np.zeros(int(offs.max()) - off_min + 1, dtype=bool)
    present[offs - off_min] = True
    return {int(o) for o in np.flatnonzero(present) + off_min}


def _dia_pack(tri: _Tri, offsets: tuple, r: int) -> np.ndarray:
    """A block triangle as (D, r) bands on ``offsets``."""
    D = len(offsets)
    if tri.nnz == 0:
        return np.zeros((D, r))
    rows = np.repeat(np.arange(tri.row_ptr.shape[0] - 1, dtype=np.int64),
                     np.diff(tri.row_ptr))
    off_arr = np.array(offsets, dtype=np.int64)
    lookup = np.zeros(int(off_arr.max()) - int(off_arr.min()) + 1, np.int64)
    lookup[off_arr - off_arr.min()] = np.arange(D)
    d_idx = lookup[tri.col_idx.astype(np.int64) - rows - int(off_arr.min())]
    return np.bincount(d_idx * r + rows, weights=tri.vals, minlength=D * r).reshape(D, r)


def _csr_pad(tri: _Tri, r: int, K: int):
    """A block triangle as fixed-shape (r+1,) and (K,) padded arrays."""
    nnz, nb = tri.nnz, tri.row_ptr.shape[0] - 1
    ptr = np.full(r + 1, nnz, np.int32)
    ptr[:nb + 1] = tri.row_ptr
    col = np.zeros(K, np.int32)
    rid = np.full(K, r - 1, np.int32)
    val = np.zeros(K)
    col[:nnz] = tri.col_idx
    rid[:nnz] = np.repeat(np.arange(nb, dtype=np.int32), np.diff(tri.row_ptr))
    val[:nnz] = tri.vals
    return ptr, col, rid, val


_EMPTY = _Tri(np.zeros(1, np.int64), np.zeros(0, np.int32), np.zeros(0))


def build_bilu_jacobi(A, n_shards: int, rows_per: int, dtype: torch.dtype, steps: int,
                      owned=None, exchange=None):
    """Factor each (owned) block's diagonal block with ILU(0) and return
    the ``BlockILUDia`` form when the offsets' union passes the DIA gates,
    else the ``BlockILUCSR`` form (``gmres_tpu/precond/bilu.py:
    build_bilu_jacobi``, value for value).  ``A`` is the fp64 operator, a
    ``CSRMatrix`` or a ``RowBlockCSR`` covering the owned blocks;
    ``exchange`` combines the ranks' metadata (required unless every rank
    builds every block)."""
    n = A.n_rows
    is_block = isinstance(A, RowBlockCSR)
    fill = sorted(owned) if owned is not None else list(range(n_shards))
    rp, ci_g, v_g = host_arrays(A)

    facs = {}  # block -> (lower, upper, inv_diag, rows) or None past the matrix
    offs_l, offs_u = set(), set()
    nnz_l = nnz_u = max_kl = max_ku = 0
    for s in fill:
        lo, hi = s * rows_per, min((s + 1) * rows_per, n)
        nb = max(0, hi - lo)
        if nb == 0:
            facs[s] = None
            continue
        ci_s, v_s = A.entries(lo, hi) if is_block else (ci_g[rp[lo]:rp[hi]], v_g[rp[lo]:rp[hi]])
        rows_s = np.repeat(np.arange(nb, dtype=np.int64), np.diff(rp[lo:hi + 1]))
        ci64 = np.asarray(ci_s).astype(np.int64)
        keep = (ci64 >= lo) & (ci64 < hi)
        rows_k = rows_s[keep]
        cols_k = (ci64[keep] - lo).astype(np.int32)
        sub_rp = np.zeros(nb + 1, np.int64)
        np.cumsum(np.bincount(rows_k, minlength=nb), out=sub_rp[1:])
        if int((cols_k == rows_k).sum()) != nb:
            raise ValueError(
                f"block rows [{lo}, {hi}) lack an explicit diagonal entry in some row; load "
                "through io.loader (the reference contract forces a diagonal, "
                "LoadMatrix.hpp:97-101)")
        fvals, diag = ilu0_factorize(sub_rp, cols_k,
                                     np.asarray(v_s)[keep].astype(np.float64),
                                     factor_dtype=dtype)
        lower, upper, inv_d = _triangles(sub_rp, cols_k, fvals.double().numpy(), diag, dtype)
        facs[s] = (lower, upper, inv_d, nb)
        offs_l |= _tri_offsets(lower)
        offs_u |= _tri_offsets(upper)
        nnz_l += lower.nnz
        nnz_u += upper.nnz
        max_kl, max_ku = max(max_kl, lower.nnz), max(max_ku, upper.nnz)

    if exchange is not None:
        payload = np.concatenate([pack_offsets(offs_l, _MAXD), pack_offsets(offs_u, _MAXD),
                                  np.array([nnz_l, nnz_u, max_kl, max_ku], np.int64)])
        g = np.asarray(exchange(payload))
        u_l = union_offsets(g[:, :_MAXD + 1], _MAXD)
        u_u = union_offsets(g[:, _MAXD + 1:2 * (_MAXD + 1)], _MAXD)
        tail = g[:, 2 * (_MAXD + 1):]
        nnz_l, nnz_u = int(tail[:, 0].sum()), int(tail[:, 1].sum())
        max_kl, max_ku = int(tail[:, 2].max()), int(tail[:, 3].max())
    else:
        u_l = offs_l if len(offs_l) <= _MAXD else None
        u_u = offs_u if len(offs_u) <= _MAXD else None
    use_dia = (u_l is not None and u_u is not None
               and (len(u_l) + len(u_u)) * rows_per * n_shards <= 3.0 * max(nnz_l + nnz_u, 1))

    def stack(pieces, tail_shape, dt=np.float64):
        return stack_pieces(pieces, (n_shards, *tail_shape), dt, owned)

    inv_pieces = {}
    for s in fill:
        inv_pieces[s] = np.ones(rows_per)
        if facs[s] is not None:
            inv_pieces[s][:facs[s][3]] = facs[s][2]
    if use_dia:
        # a globally empty triangle keeps one zero band, so every rank
        # sweeps the same structure
        offsets_l = tuple(sorted(u_l)) or (-1,)
        offsets_u = tuple(sorted(u_u)) or (0,)
        lo_p, up_p = {}, {}
        for s in fill:
            f = facs[s]
            lo_p[s] = _dia_pack(_EMPTY if f is None else f[0], offsets_l, rows_per)
            up_p[s] = _dia_pack(_EMPTY if f is None else f[1], offsets_u, rows_per)
        return BlockILUDia(lower=stack(lo_p, (len(offsets_l), rows_per)),
                           upper=stack(up_p, (len(offsets_u), rows_per)),
                           inv_diag=stack(inv_pieces, (rows_per,)), offsets_l=offsets_l,
                           offsets_u=offsets_u, steps=steps, dtype=dtype)

    K_l = max(128, -(-max_kl // 128) * 128)
    K_u = max(128, -(-max_ku // 128) * 128)
    keys = ("l_ptr", "l_col", "l_rid", "l_val", "u_ptr", "u_col", "u_rid", "u_val")
    parts = {k: {} for k in keys}
    for s in fill:
        f = facs[s]
        arrays = (_csr_pad(_EMPTY if f is None else f[0], rows_per, K_l)
                  + _csr_pad(_EMPTY if f is None else f[1], rows_per, K_u))
        for k, a in zip(keys, arrays):
            parts[k][s] = a
    shapes = {"ptr": (rows_per + 1,), "l": (K_l,), "u": (K_u,)}
    out = {k: stack(parts[k], shapes["ptr"] if k.endswith("ptr") else shapes[k[0]],
                    np.float64 if k.endswith("val") else np.int32) for k in keys}
    return BlockILUCSR(**out, inv_diag=stack(inv_pieces, (rows_per,)), steps=steps,
                       rows_per=rows_per, dtype=dtype)


def localize_bilu(M, rank: int) -> ILUJacobiPrec:
    """Rank ``rank``'s block of a block-Jacobi ILU as an ``ILUJacobiPrec``
    with ``block_local`` set (its sweeps run without collectives), in M's
    dtype on the CPU: DIA bands, or for the CSR form the triangles packed
    into sliced ELL (fp32, fp64; CSR when the packer refuses them or they
    are bf16)."""
    dt = M.dtype
    tensor = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    if isinstance(M, BlockILUDia):
        r = M.inv_diag[rank].shape[0]
        band = lambda data, offs: DIAMatrix(data=tensor(data[rank]), offsets=offs, n_rows=r,
                                            n_cols=r, nnz=len(offs) * r)
        return ILUJacobiPrec(lower=band(M.lower, M.offsets_l), upper=band(M.upper, M.offsets_u),
                             inv_diag=tensor(M.inv_diag[rank]), steps=M.steps,
                             block_local=True)
    if isinstance(M, BlockILUCSR):
        def tri(ptr, col, val):
            p = ptr[rank].astype(np.int64)
            return csr_from_arrays(p, col[rank, :p[-1]], tensor(val[rank, :p[-1]]),
                                   n_cols=M.rows_per)

        prec = ILUJacobiPrec(lower=tri(M.l_ptr, M.l_col, M.l_val),
                             upper=tri(M.u_ptr, M.u_col, M.u_val),
                             inv_diag=tensor(M.inv_diag[rank]), steps=M.steps, block_local=True)
        return sell_pack_factors(prec)
    raise TypeError(f"not a block-ILU preconditioner: {type(M).__name__}")
