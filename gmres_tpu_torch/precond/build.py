"""Preconditioner construction (host, setup time).

Mirrors the reference's dispatch (``gmres_perf_test.cpp:68-92``): ILU and
ILU-Jacobi factor the fp64 matrix with ILU(0) and downcast (in fp32, fp64
or bf16: bf16 factors are rounded by torch, bit for bit as the JAX package
rounds them with ``ml_dtypes``), Jacobi extracts a safeguarded inverse
diagonal, identity is a no-op.  Every build function works
in numpy on the host and returns CPU tensors; ``.to(device)`` moves them.

Exact ILU (``build_ilu_exact``) keeps ``gmres_tpu``'s routing
(``gmres_tpu/precond/build.py:278-412``) with the H100's branches:

- a factor with at most ``_SHALLOW_LEVELS`` dependency levels is that many
  plain Jacobi sweeps (``ILUJacobiPrec``);
- banded factors become ``ExactILUDIAPrec``, applied by kernel K6 in fp32
  and in fp64 (the TPU kernel was fp32-only and sent fp64 to sweeps; bf16
  factors never take it, as in the JAX package), the
  level schedule K6 runs built once when ``.to`` moves the preconditioner
  to the card (a CPU solve runs the plain sweeps and needs none).  Fused
  when the working set ``(D_l + D_u + 5) * itemsize * n`` fits
  ``_TRISOLVE_L2_BYTES``, else segmented into as few equal segments as
  keep each within it.  On the
  card both forms are one launch of the same schedule (the same bits and
  time, PERF.md), so the split decides only the plain versions' form;
- otherwise full sweeps within ``_SWEEP_WORK_BUDGET``, then the
  level-scheduled ``LevelILUPrec``, then refusal.

``optimize_precond_format`` repacks ILU-Jacobi factors to DIA (one K1
launch per sweep; bf16 bands take the plain-torch bf16 DIA route, the JAX
package's XLA formula) and ``sell_pack_factors`` packs fp32 and fp64
factors DIA refuses into the port's sliced ELL (one K5 launch per sweep)
at every size, as the operator is packed; bf16 ones stay CSR, as a bf16
operator does (K5 has no bf16 form).  The block-Jacobi ILU of a
distributed solve is ``precond/bilu.py``; ``build_jacobi_rowblock`` is
Jacobi from one rank's rows (``RowBlockCSR``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.config import GmresConfig, Precond
from gmres_tpu_torch.ops.cuda.trisolve_kernel import LevelSchedule, level_schedule
from gmres_tpu_torch.ops.dia import from_csr
from gmres_tpu_torch.ops.sell import sell_from_csr
from gmres_tpu_torch.precond import level_ilu
from gmres_tpu_torch.precond.ilu0 import (
    diag_positions,
    ilu0_factorize,
    triangular_level_counts,
    triangular_levels,
)
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_arrays
from gmres_tpu_torch.utils.profiling import span

# Bytes of factor bands and vectors of the fused form; a larger working set
# takes the segmented form (set when each K6 sweep re-read the working set
# from L2: fused won at 36 MiB, fp32 1M rows, and two segments at 72 MiB,
# fp64 1M; the level-scheduled K6 runs both forms alike).
_TRISOLVE_L2_BYTES = 48 * 1024 * 1024

# At or below this many dependency levels the exact solve is that many
# plain sweeps (commit ef2036c; red-black orderings have 2).
_SHALLOW_LEVELS = 8

# Per-apply element-op ceiling for exact solves run as sweeps (full sweeps
# or level-scheduled chunks); past it the build refuses.  Kept from the JAX
# package, not measured on the H100.
_SWEEP_WORK_BUDGET = 2_000_000_000


@dataclasses.dataclass(frozen=True)
class IdentityPrec:
    def to(self, device) -> "IdentityPrec":
        return self


@dataclasses.dataclass(frozen=True)
class JacobiPrec:
    """Inverse main diagonal with the reference's pivot safeguard
    ``alpha = eps(float32) * max_i ||row_i||_1`` (``types.hpp:397-431``;
    the reference uses float eps whatever the build dtype)."""

    inv_diag: torch.Tensor

    def to(self, device) -> "JacobiPrec":
        with span("precond.upload"):
            return JacobiPrec(inv_diag=self.inv_diag.to(device))


@dataclasses.dataclass(frozen=True)
class ILUJacobiPrec:
    """ILU(0) factors applied by Jacobi-sweep triangular solves
    (``types.hpp:251-372``, ``kernels.hpp:172-248``): ``steps`` sweeps per
    triangle, exact when ``steps`` is the dependency-level count.

    ``lower`` is the strictly-lower part (unit diagonal implied) and
    ``upper`` the upper part with the diagonal, each a CSR, DIA or SELL
    operator.  ``block_local``: the factors are one rank's diagonal block
    of a block-Jacobi ILU (``precond/bilu.py``), so the sweeps of a
    distributed apply run without collectives."""

    lower: object
    upper: object
    inv_diag: torch.Tensor
    steps: int
    block_local: bool = False

    def to(self, device) -> "ILUJacobiPrec":
        with span("precond.upload"):
            return dataclasses.replace(self, lower=self.lower.to(device),
                                       upper=self.upper.to(device),
                                       inv_diag=self.inv_diag.to(device))


@dataclasses.dataclass(frozen=True)
class ExactILUDIAPrec:
    """Exact ILU(0) triangular solves over DIA factor bands, applied by
    kernel K6 (``ops/cuda/trisolve_kernel.py``) in one launch per apply.

    ``seg > 0`` selects the segmented form: segments of ``seg`` rows (the
    last may be partial), each sweeping its own intra-segment level count
    (``steps_l_segs``/``steps_u_segs``).  ``schedule`` is the level schedule
    the kernel runs: ``.to`` a CUDA device builds it (once: a preconditioner
    that has one keeps it), and only the kernel reads it."""

    lower_bands: torch.Tensor   # (>= D_l, width) strictly-lower bands
    upper_bands: torch.Tensor   # (>= D_u, width) strictly-upper bands
    inv_diag: torch.Tensor      # (width,)
    offs_l: tuple
    offs_u: tuple
    steps_l: int
    steps_u: int
    seg: int = 0
    steps_l_segs: tuple = ()
    steps_u_segs: tuple = ()
    schedule: LevelSchedule | None = None

    def to(self, device) -> "ExactILUDIAPrec":
        with span("precond.upload"):
            moved = dataclasses.replace(self, lower_bands=self.lower_bands.to(device),
                                        upper_bands=self.upper_bands.to(device),
                                        inv_diag=self.inv_diag.to(device))
            if moved.inv_diag.is_cuda:
                schedule = self.with_schedule().schedule.to(device)
                moved = dataclasses.replace(moved, schedule=schedule)
            elif self.schedule is not None:
                moved = dataclasses.replace(moved, schedule=self.schedule.to(device))
            return moved

    def with_schedule(self) -> "ExactILUDIAPrec":
        """This preconditioner with its level schedule (built on the host
        from the bands, for segments of ``seg`` rows, where it has none)."""
        if self.schedule is not None:
            return self
        with span("precond.levels"):
            schedule = level_schedule(self.lower_bands, self.upper_bands, self.inv_diag,
                                      self.offs_l, self.offs_u, self.seg)
        return dataclasses.replace(self, schedule=schedule)


def _rounded(values: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """``values`` rounded to ``dtype`` (to nearest even; torch also rounds
    to bf16, which numpy has no dtype for), returned in fp64."""
    return torch.from_numpy(np.asarray(values, dtype=np.float64)).to(dtype).double().numpy()


def _safeguarded_inverse(dv: np.ndarray, row_abs: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    alpha = float(np.finfo(np.float32).eps) * float(row_abs.max(initial=0.0))
    clamped = np.where(dv >= 0, np.maximum(dv, alpha), np.minimum(dv, -alpha))
    return torch.from_numpy(1.0 / clamped).to(dtype)


def build_jacobi(A: CSRMatrix, dtype: torch.dtype) -> JacobiPrec:
    rp, ci, vals = A.numpy_arrays()
    rp = rp.astype(np.int64)
    nnz = int(rp[-1])
    ci = ci[:nnz].astype(np.int64)
    # the reference builds Jacobi<PrecType> from a PrecType copy of A, so
    # the row norms and the diagonal come from the downcast values
    v = _rounded(vals[:nnz], dtype)
    row_ids = np.repeat(np.arange(A.n_rows, dtype=np.int64), np.diff(rp))
    row_abs = np.zeros(A.n_rows)
    np.add.at(row_abs, row_ids, np.abs(v))
    dv = v[diag_positions(rp, ci)]
    return JacobiPrec(inv_diag=_safeguarded_inverse(dv, row_abs, dtype))


def build_jacobi_rowblock(A_blk, dtype: torch.dtype, exchange) -> JacobiPrec:
    """``build_jacobi`` from one rank's ``RowBlockCSR``
    (``gmres_tpu/precond/build.py:build_jacobi_rowblock``): each rank takes
    the row sums and diagonal of its own rows; the safeguard's global
    ``alpha`` and the global inverse diagonal come from ``exchange``
    rounds, so the result equals ``build_jacobi`` of the whole matrix.  The
    O(n) inverse diagonal is held whole on every rank."""
    lo, hi, n = A_blk.row_lo, A_blk.row_hi, A_blk.n_rows
    rp = np.asarray(A_blk.row_ptr).astype(np.int64)
    ci, v_raw = A_blk.entries(lo, hi)
    ci = np.asarray(ci).astype(np.int64)
    v = _rounded(v_raw, dtype)
    nb = hi - lo
    row_ids = np.repeat(np.arange(nb, dtype=np.int64), np.diff(rp[lo:hi + 1]))
    row_abs = np.zeros(nb)
    np.add.at(row_abs, row_ids, np.abs(v))
    # round 1: the global largest row 1-norm behind alpha
    gmax = float(exchange(np.array([row_abs.max(initial=0.0)])).max())
    alpha = float(np.finfo(np.float32).eps) * gmax
    diag_mask = ci == (row_ids + lo)
    if int(diag_mask.sum()) != nb:
        raise ValueError(
            "row block lacks an explicit diagonal entry in some row; load it with "
            "io.loader.load_matrix_rows (the reference contract forces a diagonal)")
    dv = v[diag_mask]
    clamped = np.where(dv >= 0, np.maximum(dv, alpha), np.minimum(dv, -alpha))
    inv_local = _rounded(1.0 / clamped, dtype)
    # round 2: the global inverse diagonal from every rank's block
    max_rows = int(exchange(np.array([nb])).max())
    payload = np.zeros(2 + max_rows)
    payload[0], payload[1] = lo, hi
    payload[2:2 + nb] = inv_local
    inv_diag = np.ones(n)  # rows no rank holds: 1
    for row in np.asarray(exchange(payload)):
        a, b = int(row[0]), int(row[1])
        inv_diag[a:b] = row[2:2 + (b - a)]
    return JacobiPrec(inv_diag=torch.from_numpy(inv_diag).to(dtype))


def build_jacobi_from_dia(A, dtype: torch.dtype) -> JacobiPrec:
    """Jacobi from a DIA operator: the offset-0 band is the diagonal and the
    row 1-norms sum |data| down the bands."""
    data = _rounded(A.data.cpu().double().numpy(), dtype)
    try:
        d0 = A.offsets.index(0)
    except ValueError:
        raise ValueError("Jacobi preconditioner: DIA operator has no main diagonal")
    return JacobiPrec(inv_diag=_safeguarded_inverse(
        data[d0], np.abs(data).sum(axis=0), dtype))


def _split_triangles(row_ptr, col_idx, fvals, diag, dtype: torch.dtype):
    """(strictly-lower CSR, upper-with-diagonal CSR, inverse diagonal) of
    the combined factor ``fvals`` (fp64 values already rounded to ``dtype``),
    in ``dtype``: the inverse diagonal is taken in fp64 and rounded, as the
    JAX package does (``gmres_tpu/precond/build.py:75-106``)."""
    n = row_ptr.shape[0] - 1
    rp = row_ptr.astype(np.int64)
    nnz = rp[-1]
    ci = col_idx[:nnz].astype(np.int64)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    lower_mask = np.arange(nnz, dtype=np.int64) < diag[row_ids]

    def build(mask):
        rptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(row_ids[mask], minlength=n), out=rptr[1:])
        return csr_from_arrays(rptr, ci[mask], fvals[mask], n_cols=n).astype(dtype)

    inv_diag = torch.from_numpy(1.0 / fvals[diag]).to(dtype)
    return build(lower_mask), build(~lower_mask), inv_diag


def _factors(A: CSRMatrix, dtype: torch.dtype):
    """ILU(0) of A in the preconditioner dtype and its triangles: (row_ptr,
    col_idx, diag, lower, upper, inv_diag), the first three host numpy
    arrays.  The factor is computed in fp64 with the dtype's pivot floor and
    rounded to the dtype (``gmres_tpu/precond/build.py:183-191``; bf16
    through torch)."""
    if not isinstance(A, CSRMatrix):
        raise TypeError(f"ILU factors need the CSR matrix, got {type(A).__name__}")
    with span("precond.factor"):
        rp, ci, v = A.numpy_arrays()
        rp = rp.astype(np.int64)
        ci = ci[: rp[-1]]
        fvals, diag = ilu0_factorize(rp, ci, v, factor_dtype=dtype)
        lower, upper, inv_diag = _split_triangles(rp, ci, fvals.double().numpy(), diag, dtype)
    return rp, ci, diag, lower, upper, inv_diag


def build_ilu_jacobi(A: CSRMatrix, dtype: torch.dtype, steps: int) -> ILUJacobiPrec:
    _, _, _, lower, upper, inv_diag = _factors(A, dtype)
    return ILUJacobiPrec(lower=lower, upper=upper, inv_diag=inv_diag, steps=steps)


def _segment_level_counts(rp, ci, diag, seg: int):
    """Per-segment intra-segment dependency-level counts of the strict
    triangles (rows [a, a + seg) and the entries among them): the sweeps
    each segment of the segmented trisolve needs, since the rows of the
    neighbour segment it reads are final by then."""
    n = rp.shape[0] - 1
    ci64 = np.asarray(ci).astype(np.int64)
    steps_l, steps_u = [], []
    for a in range(0, n, seg):
        b = min(a + seg, n)
        lo, hi = int(rp[a]), int(rp[b])
        cols = ci64[lo:hi]
        keep = (cols >= a) & (cols < b)
        rows = np.repeat(np.arange(b - a, dtype=np.int64), np.diff(rp[a:b + 1]))
        sub_rp = np.zeros(b - a + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows[keep], minlength=b - a), out=sub_rp[1:])
        kept_before = np.concatenate([[0], np.cumsum(keep)])
        sub_diag = kept_before[diag[a:b] - lo]
        nl, nu = triangular_level_counts(sub_rp, cols[keep] - a, sub_diag)
        steps_l.append(nl)
        steps_u.append(nu)
    return tuple(steps_l), tuple(steps_u)


def _exact_dia(rp, ci, diag, lower, upper, inv_diag, steps_l, steps_u):
    """ExactILUDIAPrec when both triangles repack to DIA, fused or
    segmented by the working set; else None."""
    lo_dia, up_dia = from_csr(lower), from_csr(upper)
    if lo_dia is None or up_dia is None or 0 not in up_dia.offsets:
        return None
    offs_l = lo_dia.offsets
    offs_u = tuple(o for o in up_dia.offsets if o > 0)
    n = lower.n_rows
    up_rows = [up_dia.offsets.index(o) for o in offs_u]
    prec = ExactILUDIAPrec(lower_bands=lo_dia.data, upper_bands=up_dia.data[up_rows],
                           inv_diag=inv_diag, offs_l=offs_l,
                           offs_u=offs_u, steps_l=steps_l, steps_u=steps_u)
    working_set = (len(offs_l) + len(offs_u) + 5) * inv_diag.element_size() * n
    if working_set <= _TRISOLVE_L2_BYTES:
        return prec
    # as few equal segments as keep each one's share of the working set
    # within the budget, in multiples of 1024 rows; a segment must be at
    # least as wide as the bands
    n_seg = -(-working_set // _TRISOLVE_L2_BYTES)
    seg = -(-n // (n_seg * 1024)) * 1024
    band = max(abs(o) for o in offs_l + offs_u)
    if seg < max(band, 1024):
        return None
    sl, su = _segment_level_counts(rp, ci, diag, seg)
    return dataclasses.replace(prec, seg=seg, steps_l_segs=sl, steps_u_segs=su)


def build_ilu_exact(A: CSRMatrix, dtype: torch.dtype, allow_fused: bool = True):
    """Exact ILU(0) triangular solves as level-count Jacobi sweeps (the
    strict triangles are nilpotent of that index), routed as the module
    docstring says.  A bf16 M never takes the K6 form: the JAX package sends
    only fp32 to its fused kernel (``gmres_tpu/precond/build.py:319-320``),
    and K6 has no bf16 form, so bf16 takes the sweeps, the level-scheduled
    form or the refusal.  ``allow_fused=False`` skips the K6 form and the
    level-scheduled one and returns the sweep form (the same exact solve,
    its factors and level counts; ``solve_batched`` applies it to every lane
    with K1's lane form), or raises where its work is over the budget
    (``gmres_tpu/precond/build.py:278-330, 385-409``)."""
    rp, ci, diag, lower, upper, inv_diag = _factors(A, dtype)
    with span("precond.levels"):
        nlev_l, nlev_u = triangular_level_counts(rp, ci, diag)
    steps = max(nlev_l, nlev_u)
    if steps <= _SHALLOW_LEVELS:
        return ILUJacobiPrec(lower=lower, upper=upper, inv_diag=inv_diag, steps=steps)
    if allow_fused and dtype != torch.bfloat16:
        prec = _exact_dia(rp, ci, diag, lower, upper, inv_diag, nlev_l, nlev_u)
        if prec is not None:
            return prec
    nnz = int(rp[-1])
    if steps * max(nnz, 1) <= _SWEEP_WORK_BUDGET:
        return ILUJacobiPrec(lower=lower, upper=upper, inv_diag=inv_diag, steps=steps)
    if allow_fused:
        # level-scheduled chunks pay sum_c sweeps_c * nnz_c instead
        lev_l, lev_u = triangular_levels(rp, ci, diag)
        prec, work = level_ilu.build_level_ilu(lower, upper, inv_diag, lev_l, lev_u)
        if work <= _SWEEP_WORK_BUDGET:
            return prec
    # the JAX package's refusal, word for word (gmres_tpu/precond/build.py:403-410)
    raise ValueError(
        f"exact-ILU triangular solves need {steps} dependency-level "
        f"sweeps over {nnz} nonzeros per application; the factors fit "
        "neither the fused VMEM kernel nor the level-scheduled work "
        "budget — this would be prohibitively slow on TPU. Use "
        "precond='ilu_jacobi' (the reference's TPU-friendly variant) "
        "or a smaller problem.")


def optimize_precond_format(M):
    """Repack CSR ILU-Jacobi factors to DIA when banded."""
    if isinstance(M, ILUJacobiPrec) and isinstance(M.lower, CSRMatrix):
        lo, up = from_csr(M.lower), from_csr(M.upper)
        if lo is not None and up is not None:
            return dataclasses.replace(M, lower=lo, upper=up)
    return M


def sell_pack_factors(M):
    """Pack fp32 or fp64 CSR ILU-Jacobi factors (DIA refused them) into
    sliced ELL, so each sweep is a K5 launch instead of the plain CSR route;
    a triangle the packer refuses, or bf16 factors, keep both on CSR."""
    if not (isinstance(M, ILUJacobiPrec) and isinstance(M.lower, CSRMatrix)
            and isinstance(M.upper, CSRMatrix) and M.inv_diag.dtype != torch.bfloat16):
        return M
    lo, up = sell_from_csr(M.lower), sell_from_csr(M.upper)
    if lo is None or up is None:
        return M
    return dataclasses.replace(M, lower=lo, upper=up)


def build_preconditioner(A, cfg: GmresConfig):
    """Build the preconditioner in the configured dtype from the (fp64)
    assembled matrix; the result lies on the CPU."""
    with span("precond.build"):
        dtype = cfg.precision.precond_dtype
        if cfg.precond == Precond.BILU_JACOBI:
            # the JAX package's refusal, word for word (gmres_tpu/precond/build.py:487-493)
            raise ValueError(
                "precond='bilu_jacobi' is the distributed block-Jacobi ILU "
                "(each shard factors its diagonal block — precond/bilu.py); "
                "use solve_distributed, or precond='ilu_jacobi' for "
                "single-device solves"
            )
        if cfg.precond == Precond.IDENTITY:
            return IdentityPrec()
        if cfg.precond == Precond.JACOBI:
            if isinstance(A, CSRMatrix):
                return build_jacobi(A, dtype)
            if hasattr(A, "offsets"):
                return build_jacobi_from_dia(A, dtype)
            raise TypeError(f"jacobi preconditioner for {type(A).__name__}")
        if not isinstance(A, CSRMatrix):
            raise TypeError(
                f"{cfg.precond.value} preconditioner needs the CSR matrix; pass the CSR "
                "form to solve() or prebuild M with build_preconditioner(csr, cfg) and "
                "pass it as M=")
        if cfg.precond == Precond.ILU_JACOBI:
            return build_ilu_jacobi(A, dtype, cfg.jacobi_steps)
        if cfg.precond == Precond.ILU:
            return build_ilu_exact(A, dtype)
        raise ValueError(f"unknown preconditioner {cfg.precond}")
