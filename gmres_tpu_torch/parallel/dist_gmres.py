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

Operators: with ``cfg.auto_format`` the halo partition (``parallel/
halo.py``: a DIA block on kernel K12, or a rebased CSR block, each fed by a
neighbour exchange), else, or when the pattern couples more than
neighbours, the allgather partition (``parallel/partition.py``).  The
identity, Jacobi and ILU-Jacobi preconditioners are partitioned like A
(``DistILUJacobiPrec``).

Every precision tier of the single-device solve runs here: the native
fp64/fp32 cycles, the compressed basis, the bf16 inner tier and the df64
tier.  Every sum over the ranks is taken in the accumulation dtype
(``Comm.all_reduce_sum``); the df64 tier adds the ranks' fp64 pair sums
(``ops/df64.py``) and runs each rank's SpMV as merge, the fp64 halo SpMV
and split, the JAX package's route for a plain fp64 operator
(``gmres_tpu/ops/df64.py:144-148``).  A bf16 block (operator or
preconditioner factors) is partitioned on the host as its exact fp64
values and rounded back to bf16 on the rank, and runs the plain-torch bf16
route (K12 has no bf16 form).  As in the JAX package
(``gmres_tpu/parallel/dist_gmres.py:795-799``), no stall window is passed
to the restart loop, so a distributed bf16 solve never escalates to fp32.

Ranks start through ``parallel/launch.py`` (``spawn`` on one host, or
``init`` under another launcher).  On one card the ranks share it over
gloo, whose collectives stage through host memory; the shards, the SpMV,
the sweeps and the Givens tail stay on the card.

Not ported yet (slice 7b of the port, each refused with
``NotImplementedError``): ``checkpoint=``, ``precond="bilu_jacobi"``,
exact ILU, per-host row-block input (``RowBlockCSR``) and the per-rank
SELL route for unstructured fp32 operators.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig, Precond
from gmres_tpu_torch.ops.blas import nrm2
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.parallel.comm import Comm
from gmres_tpu_torch.parallel.halo import HaloCSR, HaloDIA, partition_halo
from gmres_tpu_torch.parallel.partition import (
    PartitionedCSR,
    pad_vector,
    padded_size,
    partition_rows,
)
from gmres_tpu_torch.precond.apply import typesafe_apply
from gmres_tpu_torch.precond.build import (
    IdentityPrec,
    ILUJacobiPrec,
    JacobiPrec,
    build_preconditioner,
)
from gmres_tpu_torch.solver.gmres import (
    _require_supported,
    drive_restarts,
    resolve_device,
    restart_cycle,
)
from gmres_tpu_torch.sparse import CSRMatrix

_f64 = torch.float64

# the JAX package routes an unstructured fp32 operator of at least this many
# rows to per-rank SELL (gmres_tpu/parallel/dist_gmres.py:54, 633-662)
_SELL_MIN_ROWS = 64 * 1024

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


def _partition_matrix(A: CSRMatrix, n_shards: int, use_halo: bool):
    """The halo partition when the pattern allows it, else the allgather
    row partition.  The host partitioners work in numpy, which has no bf16:
    a bf16 matrix is partitioned as its exact fp64 values (``_localize``
    rounds each block back)."""
    if A.dtype == torch.bfloat16:
        A = A.astype(torch.float64)
    if use_halo:
        H = partition_halo(A, n_shards)
        if H is not None:
            return H
    return partition_rows(A, n_shards)


def _padded_inv_diag(inv_diag: torch.Tensor, n_shards: int) -> torch.Tensor:
    # padded rows get inv_diag 1: they only ever see zero inputs
    n = inv_diag.shape[0]
    pad = torch.ones(padded_size(n, n_shards), dtype=inv_diag.dtype)
    pad[:n] = inv_diag
    return pad


def _partition_prec(M, n_shards: int, use_halo: bool):
    if isinstance(M, IdentityPrec):
        return M
    if isinstance(M, JacobiPrec):
        return JacobiPrec(inv_diag=_padded_inv_diag(M.inv_diag, n_shards))
    if isinstance(M, ILUJacobiPrec):
        return DistILUJacobiPrec(lower=_partition_matrix(M.lower, n_shards, use_halo),
                                 upper=_partition_matrix(M.upper, n_shards, use_halo),
                                 inv_diag=_padded_inv_diag(M.inv_diag, n_shards),
                                 steps=M.steps, dtype=M.inv_diag.dtype)
    raise TypeError(f"cannot partition {type(M).__name__}")


def _localize_matrix(A_p, rank: int, dtype: torch.dtype):
    """Rank ``rank``'s block in ``dtype``: a ``CSRMatrix`` with global
    columns for the allgather partition, a ``LocalHaloDIA``/``LocalHaloCSR``
    for a halo one (CPU tensors)."""
    if isinstance(A_p, PartitionedCSR):
        return A_p.local_block(rank).astype(dtype)
    if isinstance(A_p, (HaloDIA, HaloCSR)):
        return A_p.local(rank).astype(dtype)
    raise TypeError(f"not a partitioned operator: {type(A_p).__name__}")


def _localize_prec(M_p, rank: int, rows_per: int):
    """Rank ``rank``'s block of a partitioned preconditioner."""
    if isinstance(M_p, IdentityPrec):
        return M_p
    lo, hi = rank * rows_per, (rank + 1) * rows_per
    if isinstance(M_p, JacobiPrec):
        return JacobiPrec(inv_diag=M_p.inv_diag[lo:hi].clone())
    return ILUJacobiPrec(lower=_localize_matrix(M_p.lower, rank, M_p.dtype),
                         upper=_localize_matrix(M_p.upper, rank, M_p.dtype),
                         inv_diag=M_p.inv_diag[lo:hi].clone(), steps=M_p.steps)


def _takes_dia(A: CSRMatrix) -> bool:
    """Whether DIA takes A's pattern (cached per matrix: a host pass over
    the entries)."""
    verdict = _cache_get(A, "dia")
    if verdict is None:
        verdict = from_csr(A) is not None
        _cache_put(A, "dia", verdict)
    return verdict


def _require_supported_dist(A, cfg: GmresConfig, checkpoint) -> None:
    """Raise for what the distributed path does not run yet, before any
    collective, so that every rank raises alike."""
    if hasattr(A, "row_lo") and hasattr(A, "entries"):
        raise NotImplementedError(
            "per-host row-block input (RowBlockCSR) is slice 7b of the port; pass the "
            "whole CSRMatrix on every rank")
    if not isinstance(A, CSRMatrix):
        raise TypeError(f"solve_distributed partitions a CSRMatrix, got {type(A).__name__}")
    _require_supported(cfg.with_(axis_name=None))
    if checkpoint is not None:
        raise NotImplementedError("distributed checkpoints are slice 7b of the port")
    if cfg.precond == Precond.BILU_JACOBI:
        raise NotImplementedError(
            "precond='bilu_jacobi' (the block-Jacobi ILU) is slice 7b of the port")
    if cfg.precond == Precond.ILU:
        raise NotImplementedError(
            "distributed exact ILU is not partitioned (the JAX package refuses it too); use "
            "precond='ilu_jacobi'; slice 7b of the port")
    if (cfg.auto_format and cfg.precision.inner_dtype == torch.float32
            and A.n_rows >= _SELL_MIN_ROWS and not _takes_dia(A)):
        raise NotImplementedError(
            "the per-rank SELL route for unstructured fp32 operators is slice 7b of the "
            "port; pass auto_format=False for the allgather route")


def _local_bytes(*objs) -> int:
    """Bytes of the distinct tensors held by ``objs`` (dataclasses, tuples
    and tensors, walked)."""
    seen = {}

    def walk(o):
        if isinstance(o, torch.Tensor):
            seen[id(o)] = o.nelement() * o.element_size()
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (tuple, list)):
            for e in o:
                walk(e)

    for o in objs:
        walk(o)
    return sum(seen.values())


def _stage(A: CSRMatrix, cfg: GmresConfig, M, n_shards: int, rank: int, dev):
    """This rank's (A_out, A_in, M) blocks on ``dev``, cached per matrix,
    with their bytes (``_local_bytes``) when they were staged here and None
    when they came from the cache, as the JAX package's
    ``GmresResult.partition_local_bytes`` (``gmres_tpu/parallel/
    dist_gmres.py:688-694``)."""
    p = cfg.precision
    key = (n_shards, rank, str(dev), cfg.auto_format, p.outer, p.inner, p.precond,
           cfg.precond, cfg.jacobi_steps)
    staged = _cache_get(A, key)
    if staged is None:
        Ao_p = _partition_matrix(A.astype(p.outer_dtype), n_shards, cfg.auto_format)
        if p.outer_dtype == p.inner_dtype:
            Ai_p = Ao_p
        else:
            Ai_p = _partition_matrix(A.astype(p.inner_dtype), n_shards, cfg.auto_format)
        M_p = _partition_prec(M, n_shards, cfg.auto_format)
        A_out_loc = _localize_matrix(Ao_p, rank, p.outer_dtype).to(dev)
        A_in_loc = (A_out_loc if Ai_p is Ao_p
                    else _localize_matrix(Ai_p, rank, p.inner_dtype).to(dev))
        staged = (A_out_loc, A_in_loc, _localize_prec(M_p, rank, Ao_p.rows_per_shard).to(dev),
                  Ao_p.rows_per_shard)
        _cache_put(A, key, staged)
        return staged + (_local_bytes(*staged[:3]),)
    return staged + (None,)


def _host_vector(v, dtype: torch.dtype) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", dtype).numpy()
    return torch.from_numpy(np.asarray(v)).to(dtype).numpy()


def solve_distributed(A: CSRMatrix, b, cfg: GmresConfig | None = None, group=None,
                      device=None, x0=None, record_history: bool = False, progress=None,
                      checkpoint=None):
    """Solve A x = b with the rows of A, b and x split over the ranks of
    ``group`` (the default process group when None), called with the same
    arguments on every rank.  ``device`` is the rank's device, CUDA unless
    ``"cpu"`` is given.  Returns a ``GmresResult`` whose ``x`` is the whole
    solution (gathered, the padding cut off) on ``device``, on every rank;
    its history and counts are the same on every rank.

    ``b_norm``, ``||M^-1 b||`` and ``||A||_F`` are taken on the host from
    the unpartitioned operands (``gmres_tpu/parallel/dist_gmres.py:597-621``),
    so every rank has the same bits."""
    cfg = cfg or GmresConfig()
    _require_supported_dist(A, cfg, checkpoint)
    comm = Comm(group)
    dev = resolve_device("cuda" if device is None else device)
    p = cfg.precision
    n = A.n_rows

    t0 = time.perf_counter()
    M = build_preconditioner(A, cfg)
    prec_seconds = time.perf_counter() - t0

    t1 = time.perf_counter()
    b_np = _host_vector(b, p.outer_dtype)
    b_host = torch.from_numpy(b_np)
    b_norm = nrm2(b_host).to(_f64)
    minvb_norm = nrm2(typesafe_apply(M, b_host.to(p.inner_dtype))).to(_f64)
    a_norm = nrm2(A.vals.cpu().to(p.inner_dtype)).to(_f64)
    A_out, A_in, M_loc, r, local_bytes = _stage(A, cfg, M, comm.size, comm.rank, dev)
    lo, hi = comm.rank * r, (comm.rank + 1) * r
    b_loc = torch.from_numpy(pad_vector(b_np, comm.size)[lo:hi].copy()).to(dev)
    if x0 is None:
        x = torch.zeros_like(b_loc)
    else:
        x = torch.from_numpy(pad_vector(_host_vector(x0, p.outer_dtype), comm.size)[lo:hi]
                             .copy()).to(dev)
    b_norm, minvb_norm, a_norm = (t.to(dev) for t in (b_norm, minvb_norm, a_norm))
    setup_seconds = time.perf_counter() - t1

    def cycle(x, pstate, pending):
        return restart_cycle(cfg, A_out, A_in, M_loc, b_loc, x, b_norm, minvb_norm, a_norm,
                             pstate, pending, comm)

    result = drive_restarts(cycle, x, cfg, record_history, progress)
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
    A_p = _partition_matrix(A, comm.size, True)
    r = A_p.rows_per_shard
    lo, hi = comm.rank * r, (comm.rank + 1) * r
    x_loc = torch.from_numpy(pad_vector(_host_vector(x, A.dtype), comm.size)[lo:hi].copy())
    y = spmv(_localize_matrix(A_p, comm.rank, A.dtype).to(dev), x_loc.to(dev), comm)
    return comm.all_gather(y)[:A.n_rows]


def run_cases(cases, device="cuda") -> list:
    """Solve each case on this rank and return what a spawner can carry
    back: for each case its label, outcome (the stall and escalation flags
    too), counts, history (with ``history`` set), global x (host numpy),
    host wall seconds, the bytes of the rank's staged blocks (None when they
    came from the staging cache) and the kernel launches of its solve.  A
    case is a dict with ``A``, ``b``, ``cfg`` and optionally ``x0``,
    ``history`` and ``label``.  Run it on every rank (``launch.spawn(
    run_cases, P, args=(cases, device))``)."""
    from gmres_tpu_torch.ops.cuda import launch_counts

    out = []
    for case in cases:
        before = launch_counts()
        t0 = time.perf_counter()
        res = solve_distributed(case["A"], case["b"], case["cfg"], device=device,
                                x0=case.get("x0"), record_history=case.get("history", False))
        if res.x.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = launch_counts()
        out.append(dict(label=case.get("label"), converged=res.converged, aborted=res.aborted,
                        stalled=res.stalled, escalated=res.escalated, history=res.history,
                        restarts=res.restarts, total_iters=res.total_iters,
                        x=res.x.cpu().numpy(), seconds=wall,
                        partition_local_bytes=res.partition_local_bytes,
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
