"""Row-partitioned GMRES over the ranks of a ``torch.distributed`` group.

The counterpart of ``gmres_tpu/parallel/dist_gmres.py``.  The JAX package
runs one process over a device mesh (``shard_map``); PyTorch's idiom is one
process per rank, so ``solve_distributed`` is SPMD: every rank calls it with
the same arguments, partitions the matrix on the host, keeps its own row
block on its device, and runs the single-device restart cycle
(``solver/gmres.py:restart_cycle``) with a ``Comm`` (``parallel/comm.py``)
that sums every reduction over the ranks where the JAX package psums.
Scalars are the same on every rank by construction, so each rank's host
loop (the shared ``drive_restarts``) takes the same branches.

Operators, with ``cfg.auto_format``:

- the per-rank SELL route: an unstructured operator (DIA refuses it) of at
  least 64K rows under an fp32 inner dtype, or any operator with
  ``force_sell``, is cut on the JAX package's SELL grid (``sell_rows_per``:
  blocks a multiple of 1024 rows) and each rank packs its block into the
  port's sliced ELL (``ops/sell.py``; absolute columns, the padded global
  width), which runs on kernel K5 over the gathered x; the outer residual
  is K5's rank form (``ops/cuda/outer_kernel.py``).  The JAX package's
  shared (W, K), part plan and chunk padding served ``shard_map`` and SMEM
  and are not carried;
- else the halo partition (``parallel/halo.py``: a DIA block on kernel
  K12, or a rebased CSR block, each fed by a neighbour exchange);
- else, or without ``auto_format``, the allgather partition
  (``parallel/partition.py``).

Preconditioners: identity, Jacobi, ILU-Jacobi (the global factors
partitioned like A) and the block-Jacobi ILU (``precond/bilu.py``), whose
factors are built here, at the final block height, and whose sweeps need
no collective (``||M^-1 b||`` is taken over the partitioned factors, one
sum over the ranks).  Exact ILU is refused, as in the JAX package.

Every precision tier of the single-device solve runs here: the native
fp64/fp32 cycles, the compressed basis, the bf16 inner tier and the df64
tier.  Every sum over the ranks is taken in the accumulation dtype
(``Comm.all_reduce_sum``); the df64 tier adds the ranks' fp64 pair sums
(``ops/df64.py``) and runs each rank's SpMV as merge, the fp64 SpMV and
split, the JAX package's route for a plain fp64 operator
(``gmres_tpu/ops/df64.py:144-148``).  A bf16 block (operator or
preconditioner factors) is partitioned on the host as its exact fp64
values and rounded back to bf16 on the rank, and runs the plain-torch bf16
route (K12 has no bf16 form).  As in the JAX package
(``gmres_tpu/parallel/dist_gmres.py:795-799``), no stall window is passed
to the restart loop, so a distributed bf16 solve never escalates to fp32.

Per-host partitioning (``multihost=True``, or ``RowBlockCSR`` input from
``io/loader.py:load_matrix_rows``): a rank builds only its own block of
every partitioned form (about 1/P of the partition's host bytes,
``GmresResult.partition_local_bytes``), and the metadata the partitioners
need from other rows meets in small fixed-shape all_gathers
(``parallel/multihost.py:exchange_host_array``).  Row-block input takes
identity, Jacobi (``build_jacobi_rowblock``) and the block-Jacobi ILU; an
unstructured pattern is routed by a structure vote of the ranks
(``halo.rowblock_dia_gate``).  ``process_row_range`` gives the rows a rank
must load.

``checkpoint=`` saves each rank's block of x to ``<path>.p<rank>``; on
resume the ranks exchange their headers and all adopt the lowest restart
(``_dist_ckpt_hooks``).  x is a plain fp64 vector in every tier here (the
df64 pair lives inside the cycle), so nothing is split or merged around a
save.

Ranks start through ``parallel/launch.py`` (``spawn`` on one host, or
``init`` under another launcher).  On one card the ranks share it over
gloo, whose collectives stage through host memory; the shards, the SpMV,
the sweeps and the Givens tail stay on the card.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
import weakref

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig, Precond
from gmres_tpu_torch.ops.blas import nrm2
from gmres_tpu_torch.ops.cuda.sell_kernel import SLICE
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.ops.sell import MAX_PADDING, SELLMatrix, sell_from_csr
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.parallel.comm import Comm
from gmres_tpu_torch.parallel.halo import HaloCSR, HaloDIA, partition_halo, rowblock_dia_gate
from gmres_tpu_torch.parallel.multihost import exchange_host_array
from gmres_tpu_torch.parallel.partition import (
    PartitionedCSR,
    host_arrays,
    local_partition_nbytes,
    pad_vector,
    padded_size,
    partition_rows,
)
from gmres_tpu_torch.precond.apply import typesafe_apply
from gmres_tpu_torch.precond.bilu import BlockILUCSR, BlockILUDia, build_bilu_jacobi, localize_bilu
from gmres_tpu_torch.precond.build import (
    IdentityPrec,
    ILUJacobiPrec,
    JacobiPrec,
    build_jacobi_rowblock,
    build_preconditioner,
    sell_pack_factors,
)
from gmres_tpu_torch.solver.gmres import (
    _require_supported,
    drive_restarts,
    resolve_device,
    restart_cycle,
)
from gmres_tpu_torch.solver.policies import PolicyState
from gmres_tpu_torch.sparse import CSRMatrix, RowBlockCSR, csr_from_arrays
from gmres_tpu_torch.utils.profiling import span

_f64 = torch.float64

# the JAX package routes an unstructured fp32 operator of at least this many
# rows to per-rank SELL (gmres_tpu/parallel/dist_gmres.py:54, 633-662)
_SELL_MIN_ROWS = 64 * 1024
# the JAX package's SELL grid: blocks of a multiple of this many rows
# (gmres_tpu/ops/sell.py:56, gmres_tpu/parallel/sell_dist.py:301)
SELL_GRID_ROWS = 1024

# id-keyed, weakref-cleaned cache of each matrix's staged rank blocks
_STAGE_CACHE: dict = {}


def _cache_get(A, key):
    entry = _STAGE_CACHE.get(id(A))
    if entry is not None and entry[0]() is A:
        return entry[1].get(key)
    return None


def _cache_put(A, key, value) -> None:
    entry = _STAGE_CACHE.get(id(A))
    if entry is None or entry[0]() is not A:
        aid = id(A)
        entry = (weakref.ref(A, lambda _, i=aid: _STAGE_CACHE.pop(i, None)), {})
        _STAGE_CACHE[aid] = entry
    entry[1][key] = value


@dataclasses.dataclass(frozen=True)
class DistILUJacobiPrec:
    """Row-partitioned ILU-Jacobi factors (host, in ``dtype``'s values) with
    the padded global inverse diagonal."""

    lower: object
    upper: object
    inv_diag: torch.Tensor
    steps: int
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class _PendingBILU:
    """The block-Jacobi ILU before partitioning: its factors need the final
    block height, which the operator's route sets."""

    steps: int
    dtype: torch.dtype


def sell_rows_per(n: int, n_shards: int) -> int:
    """The per-rank SELL route's block height: ceil(n / P) rounded up to a
    multiple of ``SELL_GRID_ROWS`` (``gmres_tpu/parallel/sell_dist.py:
    sell_rows_per``), so that the ranks split at the JAX package's rows."""
    return -(-n // (n_shards * SELL_GRID_ROWS)) * SELL_GRID_ROWS


def process_row_range(n: int, n_shards: int, owned, rows_per: int | None = None,
                      fmt: str = "csr") -> tuple[int, int]:
    """The contiguous global rows [lo, hi) that the blocks ``owned`` cover
    among ``n_shards`` (``gmres_tpu/parallel/dist_gmres.py:
    process_row_range``): the range a rank passes to ``load_matrix_rows``
    (in the port a rank owns ``[rank]``).  ``rows_per`` sets the block
    height (``sell_rows_per(n, P)`` for a ``force_sell`` solve); ``fmt=
    'auto'`` gives the union of the plain grid's range and the SELL grid's,
    the rows to load when the solve routes the format itself.  Raises if
    the owned blocks are not contiguous."""
    if fmt == "auto":
        if rows_per is not None:
            raise ValueError("pass either rows_per or fmt='auto', not both")
        lo1, hi1 = process_row_range(n, n_shards, owned)
        lo2, hi2 = process_row_range(n, n_shards, owned, rows_per=sell_rows_per(n, n_shards))
        return min(lo1, lo2), max(hi1, hi2)
    if fmt != "csr":
        raise ValueError(f"unknown fmt {fmt!r} (use 'csr' or 'auto')")
    owned = sorted(owned)
    if owned and owned != list(range(owned[0], owned[-1] + 1)):
        raise ValueError(
            f"process shards {owned} are not contiguous; per-host row-block input needs a "
            "contiguous shard-per-process mesh layout")
    r = rows_per if rows_per is not None else padded_size(n, n_shards) // n_shards
    if not owned:
        return 0, 0
    return min(owned) * r, min(n, (max(owned) + 1) * r)


def _host_operator(A, dtype: torch.dtype):
    """A with its values rounded to ``dtype`` for the host partitioners,
    which work in numpy: bf16 values are held as their exact fp64 values
    (each rank's block is rounded back to bf16 when it is localized)."""
    if isinstance(A, RowBlockCSR):
        v = torch.from_numpy(np.asarray(A.vals)).to(dtype)
        v = v.double() if dtype == torch.bfloat16 else v
        return dataclasses.replace(A, vals=v.numpy())
    A = A.astype(dtype)
    return A.astype(torch.float64) if dtype == torch.bfloat16 else A


def _partition_matrix(A, n_shards: int, use_halo: bool, owned=None, exchange=None):
    """The halo partition when the pattern allows it, else the allgather
    row partition (``A`` already holds the dtype's values, see
    ``_host_operator``)."""
    if use_halo:
        H = partition_halo(A, n_shards, owned=owned, exchange=exchange)
        if H is not None:
            return H
    return partition_rows(A, n_shards, owned=owned)


def _padded_inv_diag(inv_diag: torch.Tensor, n_shards: int,
                     rows_per: int | None = None) -> torch.Tensor:
    # padded rows get inv_diag 1: they only ever see zero inputs
    n = inv_diag.shape[0]
    n_pad = rows_per * n_shards if rows_per is not None else padded_size(n, n_shards)
    pad = torch.ones(n_pad, dtype=inv_diag.dtype)
    pad[:n] = inv_diag
    return pad


def _partition_prec(M, n_shards: int, use_halo: bool, rows_per=None, owned=None, A=None,
                    exchange=None):
    """M partitioned like the operator: ``rows_per`` (the SELL route's grid)
    puts every piece on that block height; the block-Jacobi ILU is built
    here from the fp64 ``A``."""
    if isinstance(M, IdentityPrec):
        return M
    if isinstance(M, _PendingBILU):
        r = rows_per if rows_per is not None else padded_size(A.n_rows, n_shards) // n_shards
        return build_bilu_jacobi(A, n_shards, r, M.dtype, M.steps, owned=owned,
                                 exchange=exchange)
    if isinstance(M, JacobiPrec):
        return JacobiPrec(inv_diag=_padded_inv_diag(M.inv_diag, n_shards, rows_per))
    if isinstance(M, ILUJacobiPrec):
        def part(T):
            T = _host_operator(T, M.inv_diag.dtype)
            if rows_per is not None:
                return partition_rows(T, n_shards, rows_per=rows_per, owned=owned)
            return _partition_matrix(T, n_shards, use_halo, owned)

        return DistILUJacobiPrec(lower=part(M.lower), upper=part(M.upper),
                                 inv_diag=_padded_inv_diag(M.inv_diag, n_shards, rows_per),
                                 steps=M.steps, dtype=M.inv_diag.dtype)
    raise TypeError(f"cannot partition {type(M).__name__}")


def _sell_block(B: CSRMatrix) -> SELLMatrix:
    """A rank's rows (global columns) in the port's sliced ELL, at any
    padding (the route's padding gate is global, ``_sell_packs``); a block
    that stores nothing packs to zero-width slices."""
    S = sell_from_csr(B, max_padding=float("inf"))
    if S is not None:
        return S
    n_slices = -(-B.n_rows // SLICE)
    return SELLMatrix(vals=torch.zeros(0, dtype=B.dtype), cols=torch.zeros(0, dtype=torch.int32),
                      slice_ptr=torch.zeros(n_slices + 1, dtype=torch.int64), n_rows=B.n_rows,
                      n_cols=B.n_cols, nnz=0)


def _localize_matrix(A_p, rank: int, dtype: torch.dtype):
    """Rank ``rank``'s block in ``dtype`` (CPU tensors): a ``CSRMatrix``
    with global columns for the allgather partition, a ``LocalHaloDIA``/
    ``LocalHaloCSR`` for a halo one."""
    if isinstance(A_p, PartitionedCSR):
        return A_p.local_block(rank).astype(dtype)
    if isinstance(A_p, (HaloDIA, HaloCSR)):
        return A_p.local(rank).astype(dtype)
    raise TypeError(f"not a partitioned operator: {type(A_p).__name__}")


def _localize_prec(M_p, rank: int, rows_per: int, sell: bool):
    """Rank ``rank``'s block of a partitioned preconditioner; on the SELL
    route the ILU-Jacobi factor rows are packed into sliced ELL as the
    operator is (fp32 and fp64)."""
    if isinstance(M_p, IdentityPrec):
        return M_p
    if isinstance(M_p, (BlockILUDia, BlockILUCSR)):
        return localize_bilu(M_p, rank)
    lo, hi = rank * rows_per, (rank + 1) * rows_per
    if isinstance(M_p, JacobiPrec):
        return JacobiPrec(inv_diag=M_p.inv_diag[lo:hi].clone())
    M = ILUJacobiPrec(lower=_localize_matrix(M_p.lower, rank, M_p.dtype),
                      upper=_localize_matrix(M_p.upper, rank, M_p.dtype),
                      inv_diag=M_p.inv_diag[lo:hi].clone(), steps=M_p.steps)
    return sell_pack_factors(M) if sell else M


def _takes_dia(A) -> bool:
    """Whether DIA takes A's pattern (cached per matrix: a host pass over
    the entries); for a ``RowBlockCSR`` the ranks' vote."""
    verdict = _cache_get(A, "dia")
    if verdict is None:
        verdict = from_csr(A) is not None
        _cache_put(A, "dia", verdict)
    return verdict


def _sell_packs(row_ptr: np.ndarray, n: int, n_shards: int, rows_per: int) -> bool:
    """Whether the blocks' sliced-ELL packs together stay within
    ``ops/sell.py:MAX_PADDING`` slots an entry (the single card's gate, on
    the whole route): a function of the global row pointer alone, so every
    rank reads the same verdict."""
    rp = np.asarray(row_ptr).astype(np.int64)
    nnz = int(rp[-1])
    if nnz == 0 or n > 1 << 31:
        return False
    lengths = np.zeros(rows_per * n_shards, dtype=np.int64)
    lengths[:n] = np.diff(rp)
    widths = lengths.reshape(-1, SLICE).max(axis=1)
    return int(widths.sum()) * SLICE <= MAX_PADDING * nnz


def _require_supported_dist(A, cfg: GmresConfig) -> None:
    """Raise for what the distributed path does not run, before any
    collective, so that every rank raises alike."""
    if not isinstance(A, (CSRMatrix, RowBlockCSR)):
        raise TypeError(f"solve_distributed partitions a CSRMatrix or a RowBlockCSR, got "
                        f"{type(A).__name__}")
    _require_supported(cfg.with_(axis_name=None))
    if cfg.precond == Precond.ILU:
        raise NotImplementedError(
            "distributed exact ILU is not partitioned (the JAX package refuses it too); use "
            "precond='ilu_jacobi' or precond='bilu_jacobi'")
    if isinstance(A, RowBlockCSR) and cfg.precond not in (Precond.IDENTITY, Precond.JACOBI,
                                                          Precond.BILU_JACOBI):
        # the JAX package's refusal, word for word (gmres_tpu/parallel/dist_gmres.py:488-497)
        raise ValueError(
            f"prec={cfg.precond.value} needs the global matrix "
            "(global ILU(0) factorization is a sequential pass); "
            "per-host RowBlockCSR input supports identity/jacobi/"
            "bilu_jacobi (block-Jacobi ILU factors each shard's "
            "diagonal block locally) — pass the full CSRMatrix for "
            "global ILU preconditioning")


@dataclasses.dataclass(frozen=True)
class _Route:
    """Where a solve's blocks lie: the SELL route or not, the block height,
    the blocks this rank builds (None: every block) and the metadata
    exchange."""

    sell: bool
    rows_per: int
    owned: frozenset | None
    exchange: object


def _route(A, cfg: GmresConfig, comm: Comm, multihost: bool, force_sell: bool) -> _Route:
    """The operator's route, decided alike on every rank
    (``gmres_tpu/parallel/dist_gmres.py:462-563, 633-662``); for a
    ``RowBlockCSR`` also checks that the loaded rows cover the rank's
    block, falling back from an auto-routed SELL grid the blocks do not
    all cover."""
    P, n = comm.size, A.n_rows
    is_block = isinstance(A, RowBlockCSR)
    owned = frozenset([comm.rank]) if multihost or is_block else None
    exchange = (lambda a: exchange_host_array(a, comm.group)) if owned is not None else None
    gate = (cfg.auto_format and cfg.precision.inner_dtype == torch.float32
            and n >= _SELL_MIN_ROWS)
    if is_block:
        want = force_sell
        if not want and gate:
            vote = _cache_get(A, "dia_vote")
            if vote is None:
                vote = rowblock_dia_gate(A, exchange)
                _cache_put(A, "dia_vote", vote)
            want = not vote
        want = want and cfg.auto_format and cfg.precision.inner_dtype == torch.float32
        lo, hi = process_row_range(n, P, owned, sell_rows_per(n, P) if want else None)
        covers = A.row_lo <= lo and hi <= A.row_hi
        if want and not force_sell:
            # every rank takes one route: if any block is too narrow for the
            # SELL grid, all fall back together
            if not bool(np.asarray(exchange(np.array([int(covers)], np.int64))).all()):
                warnings.warn(
                    "unstructured per-host input would route to SELL, but "
                    f"the loaded row block [{A.row_lo}, {A.row_hi}) does "
                    f"not cover the SELL shard grid (rows [{lo}, {hi})) on every process; "
                    "falling back to the allgather path — load with "
                    "process_row_range(n, P, [rank], fmt='auto') to enable the SELL route")
                want = False
                lo, hi = process_row_range(n, P, owned)
                covers = A.row_lo <= lo and hi <= A.row_hi
        if not covers:
            raise ValueError(
                f"row block [{A.row_lo}, {A.row_hi}) does not cover this process's shards "
                f"(rows [{lo}, {hi})); load with load_matrix_rows(path, {lo}, {hi})"
                + (" — force_sell uses the SELL shard grid (process_row_range(n, P, "
                   "[rank], rows_per=sell_rows_per(n, P)))" if force_sell else ""))
    else:
        want = (cfg.auto_format and cfg.precision.inner_dtype == torch.float32
                and (force_sell or (gate and not _takes_dia(A))))
    if want:
        rows_per = sell_rows_per(n, P)
        want = _sell_packs(A.row_ptr if is_block else host_arrays(A)[0], n, P, rows_per)
    rows_per = sell_rows_per(n, P) if want else padded_size(n, P) // P
    return _Route(want, rows_per, owned, exchange)


def _stage(A, cfg: GmresConfig, M, comm: Comm, dev, route: _Route):
    """This rank's (A_out, A_in, M) blocks on ``dev``, cached per matrix,
    with the host bytes of the partitioned forms this rank built (a
    ``ShardStack`` counting its owned pieces: ~1/P of them in per-host
    mode), None when they came from the cache (the JAX package's
    ``GmresResult.partition_local_bytes``, ``gmres_tpu/parallel/
    dist_gmres.py:686-694``)."""
    p = cfg.precision
    key = (comm.size, comm.rank, str(dev), cfg.auto_format, p.outer, p.inner, p.precond,
           cfg.precond, cfg.jacobi_steps, route.sell, route.owned is not None)
    staged = _cache_get(A, key)
    if staged is not None:
        return staged + (None,)
    A64 = A if isinstance(A, RowBlockCSR) else A.astype(_f64)
    if route.sell:
        r, lo = route.rows_per, comm.rank * route.rows_per
        if isinstance(A, RowBlockCSR):
            hi = min(lo + r, A.n_rows)
            ci, v = A.entries(min(lo, A.n_rows), hi)
            rp = A.row_ptr[min(lo, A.n_rows):hi + 1] - A.row_ptr[min(lo, A.n_rows)]
        else:
            rp64, ci_g, v_g = host_arrays(A64)
            hi = min(lo + r, A.n_rows)
            a, b = int(rp64[min(lo, A.n_rows)]), int(rp64[hi])
            rp, ci, v = rp64[min(lo, A.n_rows):hi + 1] - a, ci_g[a:b], v_g[a:b]
        rows = np.full(r + 1, rp[-1], dtype=np.int64)
        rows[:rp.shape[0]] = rp
        # the rank's rows (global columns, the padded global width), packed
        Ao_p = csr_from_arrays(rows, ci, np.asarray(v, dtype=np.float64), n_cols=r * comm.size)
        Ai_p = Ao_p
        use_halo = False
    else:
        Ao_p = _partition_matrix(_host_operator(A, p.outer_dtype), comm.size, cfg.auto_format,
                                 route.owned, route.exchange)
        Ai_p = Ao_p if p.outer_dtype == p.inner_dtype else _partition_matrix(
            _host_operator(A, p.inner_dtype), comm.size, cfg.auto_format, route.owned,
            route.exchange)
        use_halo = cfg.auto_format
    M_p = _partition_prec(M, comm.size, use_halo, route.rows_per if route.sell else None,
                          route.owned, A64, route.exchange)
    nbytes = local_partition_nbytes(Ao_p.numpy_arrays() if route.sell else Ao_p,
                                    None if Ai_p is Ao_p else Ai_p, M_p)
    A_out = (_sell_block(Ao_p).astype(p.outer_dtype) if route.sell
             else _localize_matrix(Ao_p, comm.rank, p.outer_dtype)).to(dev)
    A_in = A_out if Ai_p is Ao_p and p.outer_dtype == p.inner_dtype else (
        A_out.astype(p.inner_dtype) if route.sell
        else _localize_matrix(Ai_p, comm.rank, p.inner_dtype).to(dev))
    staged = (A_out, A_in, _localize_prec(M_p, comm.rank, route.rows_per, route.sell).to(dev))
    _cache_put(A, key, staged)
    return staged + (nbytes,)


def _host_vector(v, dtype: torch.dtype) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", dtype).numpy()
    return torch.from_numpy(np.asarray(v)).to(dtype).numpy()


def _a_norm(A, cfg: GmresConfig, route: _Route, comm: Comm) -> torch.Tensor:
    """||A||_F from the inner-dtype values: over the whole matrix, or for a
    ``RowBlockCSR`` from the ranks' fp64 partial sums over their own
    disjoint rows (a loaded block may be wider than its rows on the grid)
    (``gmres_tpu/parallel/dist_gmres.py:604-621``)."""
    in_dt = cfg.precision.inner_dtype
    if isinstance(A, RowBlockCSR):
        lo, hi = process_row_range(A.n_rows, comm.size, [comm.rank],
                                   route.rows_per if route.sell else None)
        # a block past the last row is empty (lo > hi on the SELL grid)
        av = torch.from_numpy(np.asarray(A.entries(min(lo, hi), hi)[1])).to(in_dt).double()
        ss = route.exchange(np.array([float(torch.dot(av, av))])).sum()
        return torch.tensor(np.sqrt(ss), dtype=_f64)
    return nrm2(A.vals.cpu().to(in_dt)).to(_f64)


def _dist_ckpt_hooks(checkpoint, rank: int, owned, exchange):
    """The sharded checkpoint (``gmres_tpu/parallel/dist_gmres.py:
    _dist_ckpt_hooks``): each rank saves its own contiguous block of x to
    ``<path>.p<rank>``.  A preemption can fall between two ranks' saves,
    leaving their files one interval apart, so on resume the ranks exchange
    their headers (restart, iterations, policy state) and all adopt the
    LOWEST restart; each keeps its own block of x, a block saved a restart
    later being still a valid part of a starting iterate.  If any rank's
    file is missing, every rank starts afresh.  Returns (spec, consensus)
    for ``drive_restarts``."""
    owned = sorted(owned)
    if owned != list(range(owned[0], owned[-1] + 1) if owned else []):
        raise ValueError(
            f"checkpointing needs contiguous per-process shards, got {owned}; use a "
            "contiguous shard-per-process mesh layout")
    spec = dataclasses.replace(checkpoint, path=f"{checkpoint.path}.p{rank}")
    return spec, lambda state: ckpt_consensus(state, exchange)


def ckpt_consensus(state, exchange):
    """The resume state every rank adopts, from this rank's (``load_phase``'s
    tuple or None) and the ranks' headers gathered by ``exchange``: None
    when any rank has no file, else the lowest restart's (restart,
    iterations, policy state) with this rank's own x."""
    if state is None:
        hdr = np.array([-1.0, 0, 0, 0, 0], np.float64)
    else:
        _, i, iters, ps, _ = state
        hdr = np.array([i, iters, float(bool(ps.is_first)), float(ps.second_restart_length),
                        float(ps.restart_tol)], np.float64)
    g = np.asarray(exchange(hdr))
    if (g[:, 0] < 0).any():
        if state is not None:
            warnings.warn("checkpoint files missing on some processes; restarting the solve "
                          "from scratch")
        return None
    j = int(np.argmin(g[:, 0]))
    if int(state[1]) != int(g[j, 0]):
        warnings.warn(
            f"per-process checkpoints disagree (restart {int(state[1])} here vs "
            f"{int(g[j, 0])} minimum); adopting the minimum — each process resumes from its "
            "own x block")
    pstate = PolicyState(is_first=bool(g[j, 2] != 0), second_restart_length=int(g[j, 3]),
                         restart_tol=float(g[j, 4]))
    return (state[0], int(g[j, 0]), int(g[j, 1]), pstate, state[4])


def solve_distributed(A, b, cfg: GmresConfig | None = None, group=None, device=None, x0=None,
                      record_history: bool = False, progress=None, checkpoint=None,
                      multihost: bool = False, force_sell: bool = False):
    """Solve A x = b with the rows of A, b and x split over the ranks of
    ``group`` (the default process group when None), called with the same
    arguments on every rank.  ``device`` is the rank's device, CUDA unless
    ``"cpu"`` is given.  Returns a ``GmresResult`` whose ``x`` is the whole
    solution (gathered, the padding cut off) on ``device``, on every rank;
    its history and counts are the same on every rank.

    ``A`` is the whole ``CSRMatrix`` on every rank, or each rank's
    ``RowBlockCSR`` (``load_matrix_rows`` of ``process_row_range``'s rows);
    b is whole on every rank.  ``multihost`` builds only this rank's block
    of every partitioned form; ``force_sell`` takes the per-rank SELL route
    whatever the pattern (fp32 inner, ``auto_format``); ``checkpoint`` (a
    ``utils.checkpoint.CheckpointSpec``) saves and resumes per rank (see
    the module docstring).

    ``b_norm``, ``||A||_F`` and, but for the block-Jacobi ILU, ``||M^-1
    b||`` are taken on the host from the unpartitioned operands
    (``gmres_tpu/parallel/dist_gmres.py:597-621``), so every rank has the
    same bits."""
    with span("solve", entry="solve_distributed", lanes=1):
        cfg = cfg or GmresConfig()
        _require_supported_dist(A, cfg)
        comm = Comm(group)
        dev = resolve_device("cuda" if device is None else device)
        p = cfg.precision
        n = A.n_rows
        with span("solve.prepare"):
            route = _route(A, cfg, comm, multihost, force_sell)

            t0 = time.perf_counter()
            if cfg.precond == Precond.BILU_JACOBI:
                M = _PendingBILU(steps=cfg.jacobi_steps, dtype=p.precond_dtype)
            elif isinstance(A, RowBlockCSR):
                M = (build_jacobi_rowblock(A, p.precond_dtype, route.exchange)
                     if cfg.precond == Precond.JACOBI else IdentityPrec())
            else:
                M = build_preconditioner(A, cfg)
            prec_seconds = time.perf_counter() - t0

            t1 = time.perf_counter()
            b_np = _host_vector(b, p.outer_dtype)
            b_host = torch.from_numpy(b_np)
            b_norm = nrm2(b_host).to(_f64)
            a_norm = _a_norm(A, cfg, route, comm)
            A_out, A_in, M_loc, local_bytes = _stage(A, cfg, M, comm, dev, route)
            r = route.rows_per
            lo, hi = comm.rank * r, (comm.rank + 1) * r
            b_loc = torch.from_numpy(pad_vector(b_np, comm.size, r)[lo:hi].copy()).to(dev)
            if isinstance(M, _PendingBILU):
                # the factors exist only partitioned: one sum over the ranks (padded
                # rows add exact zeros)
                w = typesafe_apply(M_loc, b_loc.to(p.inner_dtype)).to(_f64)
                minvb_norm = torch.sqrt(comm.all_reduce_sum(torch.dot(w, w))).cpu()
            else:
                minvb_norm = nrm2(typesafe_apply(M, b_host.to(p.inner_dtype))).to(_f64)
            if x0 is None:
                x = torch.zeros_like(b_loc)
            else:
                x0_np = pad_vector(_host_vector(x0, p.outer_dtype), comm.size, r)
                x = torch.from_numpy(x0_np[lo:hi].copy()).to(dev)
            b_norm, minvb_norm, a_norm = (t.to(dev) for t in (b_norm, minvb_norm, a_norm))
            setup_seconds = time.perf_counter() - t1

            hooks = {}
            if checkpoint is not None:
                spec, consensus = _dist_ckpt_hooks(
                    checkpoint, comm.rank, route.owned or [comm.rank],
                    route.exchange or (lambda a: exchange_host_array(a, group)))
                hooks = dict(checkpoint=spec, ckpt_consensus=consensus)

        def cycle(x, pstate, pending):
            return restart_cycle(cfg, A_out, A_in, M_loc, b_loc, x, b_norm, minvb_norm, a_norm,
                                 pstate, pending, comm)

        result = drive_restarts(cycle, x, cfg, record_history, progress, **hooks)
        result.x = comm.all_gather(result.x)[:n]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        result.prec_seconds = prec_seconds
        result.setup_seconds = setup_seconds
        result.solve_seconds = time.perf_counter() - t1
        result.partition_local_bytes = local_bytes
        return result


def spmv_distributed(A: CSRMatrix, x, group=None, device=None):
    """y = A x with the rows of A and x split over the ranks of ``group``,
    called alike on every rank (the halo route where the pattern allows
    it, as in ``solve_distributed``); returns the whole y on ``device``
    (CUDA unless ``"cpu"`` is given) on every rank."""
    comm = Comm(group)
    dev = resolve_device("cuda" if device is None else device)
    A_p = _partition_matrix(_host_operator(A, A.dtype), comm.size, True)
    r = A_p.rows_per_shard
    lo, hi = comm.rank * r, (comm.rank + 1) * r
    x_loc = torch.from_numpy(pad_vector(_host_vector(x, A.dtype), comm.size)[lo:hi].copy())
    y = spmv(_localize_matrix(A_p, comm.rank, A.dtype).to(dev), x_loc.to(dev), comm)
    return comm.all_gather(y)[:A.n_rows]


def _case_matrix(case, comm: Comm, matrices: dict):
    """A case's operator on this rank: ``A`` as given, the synthetic matrix
    ``synth`` (a ``cli.solve`` spec, built once per rank), or this rank's
    rows of the ``.mtx`` file ``mtx`` (``load_matrix_rows`` of
    ``process_row_range(..., fmt=case.get("fmt", "auto"))``)."""
    if "A" in case:
        return case["A"]
    key = ("synth", case["synth"]) if "synth" in case else ("mtx", case["mtx"])
    if key not in matrices:
        if key[0] == "synth":
            from gmres_tpu_torch.cli.solve import make_synth

            matrices[key] = make_synth(key[1])
        else:
            from gmres_tpu_torch.io.loader import load_matrix_rows
            from gmres_tpu_torch.io.mmio import read_header

            n = read_header(key[1]).n_rows
            lo, hi = process_row_range(n, comm.size, [comm.rank], fmt=case.get("fmt", "auto"))
            t0 = time.perf_counter()
            matrices[key] = load_matrix_rows(key[1], lo, hi)
            matrices[("load_seconds", key[1])] = time.perf_counter() - t0
    return matrices[key]


def run_cases(cases, device="cuda") -> list:
    """Solve each case on this rank and return what a spawner can carry
    back: for each case its label, outcome (the stall and escalation flags
    too), counts, history (with ``history`` set), global x (host numpy),
    host wall seconds, setup seconds, the host bytes of the rank's
    partitioned forms (None when they came from the staging cache), the
    seconds its row block took to load (``mtx`` cases) and the kernel
    launches of its solve.  A case is a dict with ``b`` and ``cfg``, the
    operator as ``A``, ``synth`` or ``mtx`` (``_case_matrix``), and
    optionally ``x0``, ``history``, ``label``, ``checkpoint``,
    ``multihost`` and ``force_sell``.  Run it on every rank
    (``launch.spawn(run_cases, P, args=(cases, device))``)."""
    from gmres_tpu_torch.ops.cuda import launch_counts

    comm = Comm()
    matrices = {}
    out = []
    for case in cases:
        A = _case_matrix(case, comm, matrices)
        before = launch_counts()
        t0 = time.perf_counter()
        res = solve_distributed(A, case["b"], case["cfg"], device=device, x0=case.get("x0"),
                                record_history=case.get("history", False),
                                checkpoint=case.get("checkpoint"),
                                multihost=case.get("multihost", False),
                                force_sell=case.get("force_sell", False))
        if res.x.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        out.append(dict(label=case.get("label"), converged=res.converged, aborted=res.aborted,
                        stalled=res.stalled, escalated=res.escalated, history=res.history,
                        restarts=res.restarts, total_iters=res.total_iters,
                        x=res.x.cpu().numpy(), seconds=wall, setup_seconds=res.setup_seconds,
                        partition_local_bytes=res.partition_local_bytes,
                        load_seconds=matrices.get(("load_seconds", case.get("mtx"))),
                        launches={k: after[k] - before[k] for k in after}))
    return out


def dryrun_on_rank(device="cuda") -> tuple:
    """One small distributed solve on this rank (``dryrun``'s per-rank
    part): ``poisson_2d(10)``, mixed CGSR with ILU-Jacobi(2); raises unless
    it converges to x_true within 1e-4.  Returns (restarts, iterations,
    error)."""
    from gmres_tpu_torch.config import PrecisionSpec
    from gmres_tpu_torch.io.rng import rand_vect
    from gmres_tpu_torch.io.synth import poisson_2d

    A = poisson_2d(10)
    x_true = rand_vect(A.n_rows, 42)
    b = A.to_scipy() @ x_true
    cfg = GmresConfig(precision=PrecisionSpec.from_mode("mixed"), orth="cgsr",
                      precond="ilu_jacobi", jacobi_steps=2, restart_length=8, tol=1e-8,
                      max_restarts=50)
    res = solve_distributed(A, b, cfg, device=device)
    err = float(np.linalg.norm(res.x.cpu().numpy() - x_true))
    if not res.converged or err >= 1e-4:
        raise RuntimeError(f"distributed dryrun: converged={res.converged}, error {err:.3e}")
    return res.restarts, res.total_iters, err


def dryrun(world_size: int, device="cuda") -> list:
    """Spawn ``world_size`` gloo ranks on this host and run
    ``dryrun_on_rank`` on each (the JAX package's ``dryrun``,
    ``gmres_tpu/parallel/dist_gmres.py:817-841``); returns each rank's
    (restarts, iterations, error)."""
    from gmres_tpu_torch.parallel import launch

    return launch.spawn(dryrun_on_rank, world_size, args=(device,))
