"""K8 wrapper: the double-float DIA SpMV (``csrc/df64_spmv.cu``) beside its
plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/df64_kernel.py:_dia_spmv_df64`` (the
``pallas_call`` at :141, reached through ``dia_spmv_df64`` :351): with the
bands and x carried as (hi, lo) fp32 pairs,

    y[i] = sum_d  data[d, i] * x[i + offsets[d]]      in pair arithmetic,

band by band in offset order from a zero pair, x read as 0 outside
[0, n_cols).  It is every inner SpMV of a df64 solve on a DIA operator.

``dia_spmv_df64_cuda`` takes CUDA tensors only and raises on anything the
kernel does not take; ``dia_spmv_df64_plain`` runs on any device and is what
the CPU path and the on-card comparison use.  The two compute the same
chain of rounded operations, so they agree bit for bit.
"""

from __future__ import annotations

import torch

from gmres_tpu_torch.ops.cuda._build import check
from gmres_tpu_torch.ops.cuda.spmv_kernel import _band_args
from gmres_tpu_torch.ops.eft import df_add, df_mul


def dia_spmv_df64_plain(dh, dl, offsets, xh, xl):
    """(yh, yl) = A x over the pair bands, one shifted pair product and
    pair addition per band."""
    n = dh.shape[1]
    n_cols = xh.shape[0]
    yh = torch.zeros(n, dtype=torch.float32, device=dh.device)
    yl = torch.zeros_like(yh)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n_cols - off)
        if hi > lo:
            ph, pl = df_mul(dh[d, lo:hi], dl[d, lo:hi], xh[lo + off:hi + off],
                            xl[lo + off:hi + off])
            yh[lo:hi], yl[lo:hi] = df_add(yh[lo:hi], yl[lo:hi], ph, pl)
    return yh, yl


def dia_spmv_df64_cuda(dh, dl, offsets, xh, xl):
    """K8: one thread per row.  Every argument is checked before the
    library is built."""
    if dh.dtype != torch.float32:
        raise TypeError(f"dia_spmv_df64: the bands are fp32 pairs, got {dh.dtype}")
    if dh.dim() != 2 or xh.dim() != 1:
        raise ValueError(f"dia_spmv_df64: bands {tuple(dh.shape)}, x {tuple(xh.shape)}")
    n_cols = xh.shape[0]
    for name, t, shape in (("data_lo", dl, dh.shape), ("x_hi", xh, (n_cols,)),
                           ("x_lo", xl, (n_cols,))):
        check(name, t, torch.float32, shape, dh.device)
    lib, _, D, n, offs = _band_args("dia_spmv_df64", dh, offsets)
    yh = torch.empty(n, dtype=torch.float32, device=dh.device)
    yl = torch.empty_like(yh)
    lib.call("gmres_dia_spmv_df64", dh.data_ptr(), dl.data_ptr(), xh.data_ptr(), xl.data_ptr(),
             yh.data_ptr(), yl.data_ptr(), n, n_cols, D, offs)
    dia_spmv_df64_cuda.launches += 1
    return yh, yl


dia_spmv_df64_cuda.launches = 0
