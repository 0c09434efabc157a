"""K5 wrappers: the sliced-ELL SpMV kernel (``csrc/sell_spmv.cu``) in its
plain and residual modes, each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/sell_kernel.py``'s ``sell_spmv_pallas``
(ELL chunks and dense blocks, fp32) and, in residual mode, its
``sell_spmv_df64`` (the double-float outer residual) with native fp64.

The layout (``ops/sell.py``): slice s of 32 rows holds w_s slots per row,
column-major at ``slice_ptr[s] + k*32 + r``, with w_s = (slice_ptr[s+1] -
slice_ptr[s]) / 32; padding slots hold value 0 and a valid column.

    y[i] = sum_k vals[slot(i, k)] * x[cols[slot(i, k)]]
    r = b - A x,  ||r'||^2,  ||x||^2               (residual mode)

The ``*_cuda`` wrappers take CUDA tensors only and raise on anything the
kernel does not take; the ``*_plain`` versions run on any device and are
what the CPU path and the on-card comparisons use.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.cuda._build import check, kernel_dtype, library

SLICE = 32  # rows per slice: one warp of the kernel


def _slot_rows(slice_ptr: torch.Tensor) -> torch.Tensor:
    """The row of every slot (rows past n_rows in the last slice included)."""
    n_slices = slice_ptr.shape[0] - 1
    widths = torch.diff(slice_ptr) // SLICE
    slot_slice = torch.repeat_interleave(
        torch.arange(n_slices, device=slice_ptr.device), widths * SLICE)
    lane = torch.arange(slot_slice.shape[0], device=slice_ptr.device) % SLICE
    return slot_slice * SLICE + lane


def sell_spmv_plain(vals, cols, slice_ptr, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """y = A x: a gather of x over the slot array, then a sum over each
    row's slots (padding slots add 0)."""
    prod = vals * x[cols.long()]
    n_pad = (slice_ptr.shape[0] - 1) * SLICE
    y = torch.zeros(n_pad, dtype=vals.dtype, device=vals.device)
    return y.index_add_(0, _slot_rows(slice_ptr), prod)[:n_rows]


def _sell_args(name: str, vals, cols, slice_ptr, n_rows: int) -> str:
    """Validate the slot arrays (before anything is built); return the
    entry-point suffix."""
    sfx = kernel_dtype(name, vals)
    if vals.dim() != 1 or n_rows < 1:
        raise ValueError(f"{name}: vals must be 1-D and n_rows >= 1")
    dev = vals.device
    check("vals", vals, vals.dtype, tuple(vals.shape), dev)
    check("cols", cols, torch.int32, tuple(vals.shape), dev)
    check("slice_ptr", slice_ptr, torch.int64, (-(-n_rows // SLICE) + 1,), dev)
    return sfx


def sell_spmv_cuda(vals, cols, slice_ptr, x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K5, plain mode."""
    sfx = _sell_args("sell_spmv", vals, cols, slice_ptr, n_rows)
    check("x", x, vals.dtype, (x.shape[0],), vals.device)
    y = torch.empty(n_rows, dtype=vals.dtype, device=vals.device)
    library().call(f"gmres_sell_spmv_{sfx}", vals.data_ptr(), cols.data_ptr(),
                   slice_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows)
    sell_spmv_cuda.launches += 1
    return y


sell_spmv_cuda.launches = 0


def sell_residual_plain(vals, cols, slice_ptr, b, x, inner_dtype: torch.dtype):
    """(r, ||r'||^2, ||x||^2) for r = b - A x in A's dtype, where r' is r
    rounded to ``inner_dtype`` and its norm is taken in that dtype."""
    r = b - sell_spmv_plain(vals, cols, slice_ptr, x, b.shape[0])
    ri = r.to(inner_dtype)
    return r, torch.dot(ri, ri).to(torch.float64), torch.dot(x, x).to(torch.float64)


def sell_residual_cuda(vals, cols, slice_ptr, b, x, inner_dtype: torch.dtype):
    """K5, residual mode: r in A's dtype and the two sums of squares, taken
    in fp64 over per-block partials that torch.sum finishes."""
    n = b.shape[0]
    sfx = _sell_args("sell_residual", vals, cols, slice_ptr, n)
    check("b", b, vals.dtype, (n,), vals.device)
    check("x", x, vals.dtype, (n,), vals.device)
    if inner_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sell_residual: inner dtype {inner_dtype} is not float32/float64")
    lib = library()
    r = torch.empty(n, dtype=vals.dtype, device=vals.device)
    partials = torch.empty((-(-n // lib.threads), 2), dtype=torch.float64,
                           device=vals.device)
    demote = int(inner_dtype == torch.float32 and vals.dtype == torch.float64)
    lib.call(f"gmres_sell_residual_{sfx}", vals.data_ptr(), cols.data_ptr(),
             slice_ptr.data_ptr(), x.data_ptr(), b.data_ptr(), r.data_ptr(),
             partials.data_ptr(), n, demote)
    sell_residual_cuda.launches += 1
    sums = partials.sum(dim=0)
    return r, sums[0], sums[1]


sell_residual_cuda.launches = 0
