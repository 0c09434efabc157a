"""K12 wrappers: the DIA SpMV of one row shard over its block of x and the
two halo edges from its neighbours (``csrc/dia_halo.cu``), in plain and
residual modes, each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/spmv_kernel.py:dia_spmv_pallas_windowed``
and, in residual mode, ``gmres_tpu/ops/pallas/df64_kernel.py:
residual_df64_halo``:

    y[i] = sum_d data[d, i] * xv(i + offsets[d])          0 <= i < r
    r = b - A_loc xv,  ||r'||^2,  ||x||^2                  (residual mode)

where ``xv(j)`` is ``left[hl + j]`` for -hl <= j < 0, ``x[j]`` for
0 <= j < r, ``right[j - r]`` for r <= j < r + hr and 0 elsewhere, with
``hl = len(left)`` and ``hr = len(right)``.  The sums of squares are the
shard's own: the caller adds the ranks' shares.

The ``*_cuda`` wrappers take CUDA tensors only and raise on anything the
kernel does not take; the ``*_plain`` versions run on any device and are
what the CPU path and the on-card comparisons use.

The kernel (redesigned for Hopper) sends each block of ``block_rows``
rows down one of two paths: an interior block, whose rows read only x for
every band, takes a branch-free body; the blocks within max|offset| of
either end take the window path.  ``halo_plan`` is that split, which the
launcher checks against its own.
"""

from __future__ import annotations

import dataclasses

import torch

from gmres_tpu_torch.ops.cuda._build import check
from gmres_tpu_torch.ops.cuda.orth_kernel import _gram_state
from gmres_tpu_torch.ops.cuda.spmv_kernel import _band_args

THREADS = 256  # csrc/common.cuh: kThreads


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """K12's blocks: block b owns rows [b * block_rows, min((b + 1) *
    block_rows, r)); blocks [b0, b1) are interior (each of their rows i
    reads x[i + off] inside [0, r) for every band), the others take the
    window path over the edges."""

    r: int
    block_rows: int
    n_blocks: int
    b0: int
    b1: int

    def rows(self, b: int) -> range:
        return range(b * self.block_rows, min((b + 1) * self.block_rows, self.r))

    def interior(self, b: int) -> bool:
        return self.b0 <= b < self.b1


def halo_plan(offsets, r: int, hl: int, hr: int, itemsize: int,
              threads: int = THREADS) -> HaloPlan:
    """Blocks of ``threads`` 16-byte chunks of rows; the interior range is
    the blocks whose first row is at least lo = max(0, -min offset) and
    whose end is at most r - hi, hi = max(0, max offset).  The edges' sizes
    ``hl`` and ``hr`` do not enter: an interior row reads no edge, and a
    window row reads an edge only inside it."""
    if r < 1 or hl < 0 or hr < 0:
        raise ValueError(f"K12: r={r}, hl={hl}, hr={hr}")
    block_rows = threads * (16 // itemsize)
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    n_blocks = -(-r // block_rows)
    b0 = min(n_blocks, -(-lo // block_rows))
    end = n_blocks if hi == 0 else max(0, r - hi) // block_rows
    return HaloPlan(r=r, block_rows=block_rows, n_blocks=n_blocks, b0=b0, b1=max(b0, end))


def dia_spmv_halo_plain(data: torch.Tensor, offsets, x: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor) -> torch.Tensor:
    """y over the window [left | x | right], one shifted multiply-add per
    band (the JAX package's CPU branch, ``gmres_tpu/parallel/halo.py:
    450-453``)."""
    r = data.shape[1]
    hl = left.shape[0]
    xx = torch.cat([left, x, right])
    y = torch.zeros(r, dtype=data.dtype, device=data.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -(hl + off)), min(r, xx.shape[0] - hl - off)
        if hi > lo:
            y[lo:hi] += data[d, lo:hi] * xx[hl + off + lo:hl + off + hi]
    return y


def _halo_args(name, data, offsets, x, left, right):
    lib, sfx, D, r, offs = _band_args(name, data, offsets)
    check("x", x, data.dtype, (r,), data.device)
    for side, t in (("left", left), ("right", right)):
        check(side, t, data.dtype, (t.shape[0],), data.device)
    plan = halo_plan(offsets, r, left.shape[0], right.shape[0], data.element_size(),
                     lib.threads)
    return lib, sfx, D, r, offs, plan


def dia_spmv_halo_cuda(data: torch.Tensor, offsets, x: torch.Tensor, left: torch.Tensor,
                       right: torch.Tensor) -> torch.Tensor:
    """K12, plain mode."""
    lib, sfx, D, r, offs, plan = _halo_args("dia_spmv_halo", data, offsets, x, left, right)
    y = torch.empty(r, dtype=data.dtype, device=data.device)
    lib.call(f"gmres_dia_spmv_halo_{sfx}", data.data_ptr(), x.data_ptr(), left.data_ptr(),
             right.data_ptr(), y.data_ptr(), r, left.shape[0], right.shape[0], D, offs, plan.b0,
             plan.b1)
    dia_spmv_halo_cuda.launches += 1
    return y


dia_spmv_halo_cuda.launches = 0


def dia_residual_halo_plain(data, offsets, b, x, left, right, inner_dtype: torch.dtype):
    """(r, ||r'||^2, ||x||^2) over the shard's rows, r = b - A_loc xv in A's
    dtype, r' = r rounded to ``inner_dtype`` (its norm taken in that
    dtype)."""
    r = b - dia_spmv_halo_plain(data, offsets, x, left, right)
    ri = r.to(inner_dtype)
    return r, torch.dot(ri, ri).to(torch.float64), torch.dot(x, x).to(torch.float64)


def dia_residual_halo_cuda(data, offsets, b, x, left, right, inner_dtype: torch.dtype):
    """K12, residual mode: r in A's dtype and the shard's two sums of
    squares, taken in fp64 over per-block partials that the last block adds
    in block order (one launch)."""
    lib, sfx, D, r, offs, plan = _halo_args("dia_residual_halo", data, offsets, x, left,
                                            right)
    check("b", b, data.dtype, (r,), data.device)
    if inner_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_residual_halo: inner dtype {inner_dtype} is not float32/float64")
    _, ticket = _gram_state(data.device)
    res = torch.empty(r, dtype=data.dtype, device=data.device)
    partials = torch.empty((plan.n_blocks, 2), dtype=torch.float64, device=data.device)
    sums = torch.empty(2, dtype=torch.float64, device=data.device)
    demote = int(inner_dtype == torch.float32 and data.dtype == torch.float64)
    lib.call(f"gmres_dia_residual_halo_{sfx}", data.data_ptr(), x.data_ptr(), left.data_ptr(),
             right.data_ptr(), b.data_ptr(), res.data_ptr(), partials.data_ptr(),
             ticket.data_ptr(), sums.data_ptr(), r, left.shape[0], right.shape[0], D, offs,
             demote, plan.b0, plan.b1)
    dia_residual_halo_cuda.launches += 1
    return res, sums[0], sums[1]


dia_residual_halo_cuda.launches = 0
