"""K1 wrappers: the DIA SpMV kernel (``csrc/dia_spmv.cu``) in its plain and
residual modes, each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/spmv_kernel.py:dia_spmv_pallas`` and, in
residual mode, ``gmres_tpu/ops/pallas/df64_kernel.py:residual_df64``.

    y[i] = sum_d data[d, i] * x[i + offsets[d]]   (x read as 0 outside [0, n_cols))
    r = b - A x,  ||r'||^2,  ||x||^2               (residual mode)

The ``*_cuda`` wrappers take CUDA tensors only and raise on anything the
kernel does not take; the ``*_plain`` versions run on any device and are
what the CPU path and the on-card comparisons use.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from gmres_tpu_torch.ops.cuda._build import check, kernel_dtype, library


def _band_args(name: str, data: torch.Tensor, offsets):
    """Validate the band array (before anything is built); return
    (library, suffix, D, n, C array of offsets)."""
    sfx = kernel_dtype(name, data)
    if data.dim() != 2:
        raise ValueError(f"{name}: data must be (D, n), got {tuple(data.shape)}")
    D, n = data.shape
    check("data", data, data.dtype, (D, n), data.device)
    lib = library()
    if not 0 < D <= lib.max_diags or len(offsets) != D:
        raise ValueError(f"{name}: {D} bands and {len(offsets)} offsets; the "
                         f"kernel takes 1..{lib.max_diags}")
    return lib, sfx, D, n, (ctypes.c_int * D)(*offsets)


def dia_spmv_plain(data: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """y = A x over the DIA bands, one shifted multiply-add per band."""
    n = data.shape[1]
    n_cols = x.shape[0]
    y = torch.zeros(n, dtype=data.dtype, device=data.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n_cols - off)
        if hi > lo:
            y[lo:hi] += data[d, lo:hi] * x[lo + off:hi + off]
    return y


def dia_spmv_cuda(data: torch.Tensor, offsets, x: torch.Tensor) -> torch.Tensor:
    """K1, plain mode."""
    lib, sfx, D, n, offs = _band_args("dia_spmv", data, offsets)
    check("x", x, data.dtype, (x.shape[0],), data.device)
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    lib.call(f"gmres_dia_spmv_{sfx}", data.data_ptr(), x.data_ptr(), y.data_ptr(),
             n, x.shape[0], D, offs)
    dia_spmv_cuda.launches += 1
    dia_spmv_cuda.forms[sfx] += 1
    return y


dia_spmv_cuda.launches = 0
dia_spmv_cuda.forms = Counter()


def dia_residual_plain(data, offsets, b, x, inner_dtype: torch.dtype):
    """(r, ||r'||^2, ||x||^2) for r = b - A x in A's dtype, where r' is r
    rounded to ``inner_dtype`` and its norm is taken in that dtype (the
    solver's start vector, ``gmres_tpu/solver/gmres.py:489-504``)."""
    r = b - dia_spmv_plain(data, offsets, x)
    ri = r.to(inner_dtype)
    return r, torch.dot(ri, ri).to(torch.float64), torch.dot(x, x).to(torch.float64)


def dia_residual_cuda(data, offsets, b, x, inner_dtype: torch.dtype):
    """K1, residual mode: r in A's dtype and the two sums of squares, taken
    in fp64 over per-block partials that torch.sum finishes."""
    lib, sfx, D, n, offs = _band_args("dia_residual", data, offsets)
    check("b", b, data.dtype, (n,), data.device)
    check("x", x, data.dtype, (n,), data.device)
    if inner_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_residual: inner dtype {inner_dtype} is not float32/float64")
    r = torch.empty(n, dtype=data.dtype, device=data.device)
    partials = torch.empty((-(-n // lib.threads), 2), dtype=torch.float64,
                           device=data.device)
    demote = int(inner_dtype == torch.float32 and data.dtype == torch.float64)
    lib.call(f"gmres_dia_residual_{sfx}", data.data_ptr(), x.data_ptr(), b.data_ptr(),
             r.data_ptr(), partials.data_ptr(), n, D, offs, demote)
    dia_residual_cuda.launches += 1
    sums = partials.sum(dim=0)
    return r, sums[0], sums[1]


dia_residual_cuda.launches = 0
