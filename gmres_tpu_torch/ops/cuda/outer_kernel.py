"""The fp64 outer phase of a restart cycle: the true residual with its two
norms (K1 or K5 in residual mode; over the lanes of a batched solve, K1's
residual lane form) and the solution update (K4, with a pair mode for the
df64 tier's basis of fp32 pairs), each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/df64_kernel.py``'s ``residual_df64`` and
``axpy_df64``, and ``gmres_tpu/ops/pallas/sell_kernel.py``'s
``sell_spmv_df64`` where it computes the outer residual (and, through K12
for a rank's block of a halo DIA operator, ``residual_df64_halo``).  On the
TPU these carried every fp64 value as a double-float pair of fp32s (hi + lo, about
2^-48 relative), because the TPU has no fp64 units and XLA emulates fp64
in software.  The H100 has fp64 units, so the pair disappears: x, b and r
are plain fp64 tensors and the kernels compute in native fp64.  That is also what the JAX package computes on the CPU, so
the port's outer phase matches the reference's CPU branch.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import torch

from gmres_tpu_torch.ops.blas import all_reduce
from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS, acc_dtype, check, form, library
from gmres_tpu_torch.ops.cuda.sell_kernel import sell_residual_cuda, sell_residual_plain
from gmres_tpu_torch.ops.cuda.spmv_kernel import (
    dia_residual_cuda,
    dia_residual_lanes_cuda,
    dia_residual_lanes_plain,
    dia_residual_plain,
)
from gmres_tpu_torch.ops.dia import DIAMatrix
from gmres_tpu_torch.ops.sell import SELLMatrix
from gmres_tpu_torch.ops.spmv import spmv
from gmres_tpu_torch.parallel.halo import LocalHaloDIA, halo_residual


def outer_residual(A, b: torch.Tensor, x: torch.Tensor, inner_dtype: torch.dtype, comm=None):
    """(r, ||r'||^2, ||x||^2) for r = b - A x in the outer dtype, r' = r
    rounded to the inner dtype (sums as fp64 0-d tensors).  On the card a
    DIA operator takes K1's residual mode, a SELL operator K5's and a
    rank's block of a halo DIA operator K12's; a CPU operator, or a CSR
    one, the plain version.  With ``comm`` the rows are the rank's and the
    two sums are summed over the ranks in one collective; a rank's SELL
    block (global columns) takes the gathered x and K5's rank form, whose
    ||x||^2 covers the rank's own rows.  The residual
    modes round r' to fp32 or fp64; under a bf16 inner dtype ||r'||^2 is
    taken from r rounded to bf16 by torch ops (``gmres_tpu/solver/gmres.py:
    498-500``: the norm of the bf16 start vector, taken in bf16)."""
    if inner_dtype == torch.bfloat16:
        r, _, x_ss = outer_residual(A, b, x, A.dtype, comm)
        ri = r.to(inner_dtype)
        r_norm = torch.sqrt(all_reduce(torch.dot(ri, ri), comm))
        return r, r_norm.to(torch.float64) ** 2, x_ss
    if isinstance(A, DIAMatrix):
        fn = dia_residual_cuda if A.data.is_cuda else dia_residual_plain
        return fn(A.data, A.offsets, b, x, inner_dtype)
    if isinstance(A, SELLMatrix):
        fn = sell_residual_cuda if A.vals.is_cuda else sell_residual_plain
        if comm is None:
            return fn(A.vals, A.cols, A.slice_ptr, b, x, inner_dtype)
        r, r_ss, x_ss = fn(A.vals, A.cols, A.slice_ptr, b, comm.all_gather(x), inner_dtype,
                           x_off=comm.rank * b.shape[0])
    elif isinstance(A, LocalHaloDIA):
        r, r_ss, x_ss = halo_residual(A, b, x, inner_dtype, comm)
    else:
        r = b - spmv(A, x, comm)
        ri = r.to(inner_dtype)
        r_ss, x_ss = torch.dot(ri, ri).to(torch.float64), torch.dot(x, x).to(torch.float64)
    if comm is not None:
        r_ss, x_ss = comm.all_reduce_sum(torch.stack([r_ss, x_ss])).unbind()
    return r, r_ss, x_ss


def outer_residual_lanes(A, B: torch.Tensor, X: torch.Tensor, inner_dtype: torch.dtype):
    """``outer_residual`` for the s lanes of a batched solve: (R (s, n),
    ||r'_j||^2 (s,), ||x_j||^2 (s,)), each lane with the bits of
    ``outer_residual(A, B[j], X[j])``.  A DIA operator takes K1's residual
    lane form (its plain version on the CPU) in one launch per chunk of
    lanes; any other operator, or a bf16 inner dtype, goes lane by lane (a
    SELL operator through K5's residual mode)."""
    if isinstance(A, DIAMatrix) and inner_dtype != torch.bfloat16:
        fn = dia_residual_lanes_cuda if A.data.is_cuda else dia_residual_lanes_plain
        return fn(A.data, A.offsets, B, X, inner_dtype)
    R, r_ss, x_ss = zip(*(outer_residual(A, b, x, inner_dtype) for b, x in zip(B, X)))
    return torch.stack(R), torch.stack(r_ss), torch.stack(x_ss)


def basis_axpy_plain(x: torch.Tensor, V: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x += (y @ V[:len(y)]) promoted to x's dtype, in place; returns x.
    The increment has the dtype of ``jnp.matmul(y, V)`` (the promotion of
    y's and V's dtypes; ``gmres_tpu/solver/gmres.py:546-550``), summed in
    its accumulation dtype (fp32 for a bf16 increment)."""
    rows = y.shape[0]
    inc = torch.promote_types(y.dtype, V.dtype)
    acc = acc_dtype(inc)
    x += torch.mv(V[:rows].to(acc).t(), y.to(acc)).to(inc).to(x.dtype)
    return x


# K4's persistent grid: blocks an SM (csrc/basis_sweep.cu: kAxpyBlocksPerSM);
# 0 gives one block a tile.  A thread owns AXPY_COLS columns of a tile
# (kAxpyCols)
AXPY_BLOCKS_PER_SM = 4
AXPY_COLS = 8


@dataclasses.dataclass(frozen=True)
class AxpyPlan:
    """K4's launch geometry: tiles of ``tile`` = threads * AXPY_COLS columns
    (the last may be partial), a grid of ``grid`` blocks taking tiles b, b +
    grid, ...; in a tile thread ``i`` owns AXPY_COLS / ``vec`` chunks of
    ``vec`` columns (16 bytes of a basis row), chunk k at (k * threads + i)
    * vec, so that each chunk is one coalesced pass of the block."""

    n: int
    vec: int
    tile: int
    n_tiles: int
    grid: int
    threads: int = 256


def axpy_plan(n: int, itemsize: int, sms: int, blocks_per_sm: int = AXPY_BLOCKS_PER_SM,
              threads: int = 256) -> AxpyPlan:
    """Chunks of 16 bytes of a basis row of ``itemsize``-byte values, tiles
    of threads * AXPY_COLS columns, and a persistent grid of blocks_per_sm
    blocks on each SM (no more than there are tiles), or with 0 one block a
    tile."""
    tile = threads * AXPY_COLS
    n_tiles = -(-n // tile)
    grid = n_tiles if blocks_per_sm == 0 else max(1, min(n_tiles, sms * blocks_per_sm))
    return AxpyPlan(n=n, vec=16 // itemsize, tile=tile, n_tiles=n_tiles, grid=grid,
                    threads=threads)


def basis_axpy_cuda(x: torch.Tensor, V: torch.Tensor, y: torch.Tensor,
                    blocks_per_sm: int | None = None) -> torch.Tensor:
    """K4: x += sum_j y[j] V[j] in place, in one of ``AXPY_FORMS``: summed
    in the accumulation dtype of jnp's promotion of (y, V) (fp64 for an fp64
    y, else fp32; a bf16 y rounds the increment to bf16) and added to x; the
    increment is never written to memory.  ``blocks_per_sm`` overrides
    AXPY_BLOCKS_PER_SM (0: one block a tile); the bits do not depend on
    it."""
    sfx = form("basis_axpy", AXPY_FORMS, V.dtype, y.dtype, x.dtype)
    name = f"gmres_basis_axpy_{sfx}"
    rows = y.shape[0]
    if V.dim() != 2 or not 1 <= rows <= V.shape[0]:
        raise ValueError(f"basis_axpy: {rows} coefficients for V of shape {tuple(V.shape)}")
    n = V.shape[1]
    check("V", V, V.dtype, tuple(V.shape), V.device)
    check("y", y, y.dtype, (rows,), V.device)
    check("x", x, x.dtype, (n,), V.device)
    lib = library()
    if rows > lib.max_rows:
        raise ValueError(f"basis_axpy: {rows} basis rows > {lib.max_rows}")
    per_sm = AXPY_BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    sms = torch.cuda.get_device_properties(V.device).multi_processor_count
    plan = axpy_plan(n, V.element_size(), sms, per_sm, lib.threads)
    lib.call(name, V.data_ptr(), y.data_ptr(), x.data_ptr(), n, rows, plan.n_tiles, plan.grid)
    basis_axpy_cuda.launches += 1
    basis_axpy_cuda.forms[sfx] += 1
    return x


basis_axpy_cuda.launches = 0
basis_axpy_cuda.forms = Counter()


def basis_axpy(x, V, y):
    """The solution update x += V[:len(y)]^T y, in place."""
    return basis_axpy_cuda(x, V, y) if V.is_cuda else basis_axpy_plain(x, V, y)


def basis_axpy_pair_plain(x: torch.Tensor, Vh: torch.Tensor, Vl: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """x += y @ (Vh + Vl)[:len(y)] in fp64, in place; returns x."""
    rows = y.shape[0]
    x += torch.mv((Vh[:rows].double() + Vl[:rows].double()).t(), y)
    return x


def basis_axpy_pair_cuda(x: torch.Tensor, Vh: torch.Tensor, Vl: torch.Tensor,
                         y: torch.Tensor) -> torch.Tensor:
    """K4, pair mode: x += sum_j y[j] (Vh[j] + Vl[j]) for the df64 cycle's
    basis of fp32 pairs, each pair merged to fp64 in registers and summed
    in fp64; x (fp64) in place.  Counts into ``basis_axpy_cuda.launches``."""
    rows = y.shape[0]
    if Vh.dim() != 2 or not 1 <= rows <= Vh.shape[0]:
        raise ValueError(f"basis_axpy_pair: {rows} coefficients for a basis of shape "
                         f"{tuple(Vh.shape)}")
    n = Vh.shape[1]
    for name, t, dt, shape in (("Vh", Vh, torch.float32, tuple(Vh.shape)),
                               ("Vl", Vl, torch.float32, tuple(Vh.shape)),
                               ("y", y, torch.float64, (rows,)),
                               ("x", x, torch.float64, (n,))):
        check(name, t, dt, shape, Vh.device)
    lib = library()
    if rows > lib.max_rows:
        raise ValueError(f"basis_axpy_pair: {rows} basis rows > {lib.max_rows}")
    lib.call("gmres_basis_axpy_pair", Vh.data_ptr(), Vl.data_ptr(), y.data_ptr(), x.data_ptr(),
             n, rows)
    basis_axpy_cuda.launches += 1
    basis_axpy_cuda.forms["pair"] += 1
    return x


def basis_axpy_pair(x, Vh, Vl, y):
    """The df64 cycle's solution update x += (Vh + Vl)[:len(y)]^T y, in place."""
    return (basis_axpy_pair_cuda if Vh.is_cuda else basis_axpy_pair_plain)(x, Vh, Vl, y)
