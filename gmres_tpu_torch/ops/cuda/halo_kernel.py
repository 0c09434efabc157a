"""K12 wrappers: the DIA SpMV of one row shard over its block of x and the
two halo edges from its neighbours (K1's kernel, ``csrc/dia_spmv.cu``), in
plain and residual modes, each beside its plain PyTorch version.

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

K12 is K1's kernel (``csrc/dia_spmv.cu``, redesigned for Hopper) given the
two edges: each block of ``block_rows`` rows is interior, its rows reading
only x for every band, and takes the branch-free body, or lies within
max|offset| of either end of the shard and takes the window path over the
edges.  ``halo_plan`` is that split (K1's ``dia_plan`` over the shard),
which the launcher checks against its own.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.cuda._build import check
from gmres_tpu_torch.ops.cuda.spmv_kernel import (
    THREADS,
    DiaPlan,
    _band_args,
    _demote,
    dia_plan,
    launch_residual,
    launch_spmv,
)


def halo_plan(offsets, r: int, hl: int, hr: int, itemsize: int,
              threads: int = THREADS) -> DiaPlan:
    """K1's plan over the shard's r rows and the r columns of its block of
    x.  The edges' sizes ``hl`` and ``hr`` do not enter: an interior row
    reads no edge, and a window row reads an edge only inside it."""
    if r < 1 or hl < 0 or hr < 0:
        raise ValueError(f"K12: r={r}, hl={hl}, hr={hr}")
    return dia_plan(offsets, r, r, itemsize, threads=threads)


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
    return lib, sfx, offs, plan


def dia_spmv_halo_cuda(data: torch.Tensor, offsets, x: torch.Tensor, left: torch.Tensor,
                       right: torch.Tensor) -> torch.Tensor:
    """K12, plain mode."""
    lib, sfx, offs, plan = _halo_args("dia_spmv_halo", data, offsets, x, left, right)
    y = torch.empty(plan.n, dtype=data.dtype, device=data.device)
    launch_spmv(lib, sfx, data, offs, plan, x, plan.n, y, plan.n, 1, left=left, right=right)
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
    lib, sfx, offs, plan = _halo_args("dia_residual_halo", data, offsets, x, left, right)
    check("b", b, data.dtype, (plan.n,), data.device)
    demote = _demote("dia_residual_halo", data, inner_dtype)
    res = torch.empty(plan.n, dtype=data.dtype, device=data.device)
    sums = torch.empty(2, dtype=torch.float64, device=data.device)
    launch_residual(lib, sfx, data, offs, plan, x, plan.n, b, plan.n, res, plan.n, sums, demote,
                    1, left=left, right=right)
    dia_residual_halo_cuda.launches += 1
    return res, sums[0], sums[1]


dia_residual_halo_cuda.launches = 0
