"""K1 wrappers: the DIA SpMV kernel (``csrc/dia_spmv.cu``) in its plain and
residual modes, and its lane form over the s lanes of a batched solve, each
beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/spmv_kernel.py:dia_spmv_pallas`` and, in
residual mode, ``gmres_tpu/ops/pallas/df64_kernel.py:residual_df64``.

    y[i] = sum_d data[d, i] * x[i + offsets[d]]   (x read as 0 outside [0, n_cols))
    r = b - A x,  ||r'||^2,  ||x||^2               (residual mode)

    Y[j] = A X[j],  R[j] = B[j] - A X[j]  with each lane's two sums     (lane form)

The ``*_cuda`` wrappers take CUDA tensors only and raise on anything the
kernel does not take; the ``*_plain`` versions run on any device and are
what the CPU path and the on-card comparisons use.  The lane form launches
in chunks of ``LANE_CHUNKS`` lanes and counts into K1's wrappers, each
chunk as the form ``<dtype>_lanes<L>``; lane j of it is K1 on lane j, bit
for bit.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from gmres_tpu_torch.ops.cuda._build import check, kernel_dtype, library

# lanes a launch of the lane form takes (csrc/dia_spmv.cu: launch_dia_lanes)
LANE_CHUNKS = (8, 4, 2, 1)


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


def lane_chunks(s: int) -> list:
    """(first lane, lanes) of each launch over s lanes: the widest chunks of
    ``LANE_CHUNKS`` first."""
    out, j = [], 0
    for width in LANE_CHUNKS:
        while s - j >= width:
            out.append((j, width))
            j += width
    return out


def _check_lanes(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> int:
    """Raise unless ``t`` is a CUDA tensor of this dtype and (s, n) shape,
    s >= 1, whose rows are contiguous and do not overlap (the lanes may lie
    any number of values apart); returns the lane stride."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or shape[0] < 1:
        raise ValueError(f"{name}: expected shape {tuple(shape)} with a lane or more, got "
                         f"{tuple(t.shape)}")
    if (shape[1] > 1 and t.stride(1) != 1) or (shape[0] > 1 and t.stride(0) < shape[1]):
        raise ValueError(f"{name}: each lane must be contiguous and the lanes must not overlap "
                         f"(strides {t.stride()})")
    return t.stride(0)


def dia_spmv_lanes_plain(data: torch.Tensor, offsets, X: torch.Tensor) -> torch.Tensor:
    """Y[j] = A X[j] for each lane j of X (s, n_cols): ``dia_spmv_plain``'s
    elementwise shifted multiply-adds over all lanes at once, so each lane
    has its bits."""
    n = data.shape[1]
    n_cols = X.shape[1]
    Y = torch.zeros((X.shape[0], n), dtype=data.dtype, device=data.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n_cols - off)
        if hi > lo:
            Y[:, lo:hi] += data[d, lo:hi] * X[:, lo + off:hi + off]
    return Y


def dia_spmv_lanes_cuda(data: torch.Tensor, offsets, X: torch.Tensor) -> torch.Tensor:
    """K1's lane form, plain mode: Y (s, n) contiguous from the lanes of X
    (s, n_cols), read in place at their stride."""
    lib, sfx, D, n, offs = _band_args("dia_spmv_lanes", data, offsets)
    if X.dim() != 2:
        raise ValueError(f"dia_spmv_lanes: X must be (lanes, n_cols), got {tuple(X.shape)}")
    s, n_cols = X.shape
    x_ld = _check_lanes("X", X, data.dtype, (s, n_cols), data.device)
    Y = torch.empty((s, n), dtype=data.dtype, device=data.device)
    for j, width in lane_chunks(s):
        lib.call(f"gmres_dia_spmv_lanes_{sfx}", data.data_ptr(), X[j].data_ptr(), x_ld,
                 Y[j].data_ptr(), n, n, n_cols, D, offs, width)
        dia_spmv_cuda.launches += 1
        dia_spmv_cuda.forms[f"{sfx}_lanes{width}"] += 1
    return Y


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
dia_residual_cuda.forms = Counter()


def dia_residual_lanes_plain(data, offsets, B, X, inner_dtype: torch.dtype):
    """``dia_residual_plain`` for each lane: (R (s, n), ||r'_j||^2 (s,),
    ||x_j||^2 (s,)), each lane's sums taken as that function takes them."""
    R = B - dia_spmv_lanes_plain(data, offsets, X)
    r_ss = torch.stack([torch.dot(r.to(inner_dtype), r.to(inner_dtype)).to(torch.float64)
                        for r in R])
    x_ss = torch.stack([torch.dot(x, x).to(torch.float64) for x in X])
    return R, r_ss, x_ss


# a lane's residual partials start this many fp64 values after the previous
# lane's (512 bytes), so that each lane's (blocks, 2) view lies as K1's does
_PARTIALS_ALIGN = 64


def dia_residual_lanes_cuda(data, offsets, B, X, inner_dtype: torch.dtype):
    """K1's lane form, residual mode: R (s, n) contiguous and each lane's
    two sums of squares, its per-block partials finished by torch.sum lane
    by lane exactly as ``dia_residual_cuda`` finishes K1's."""
    lib, sfx, D, n, offs = _band_args("dia_residual_lanes", data, offsets)
    s = X.shape[0]
    x_ld = _check_lanes("X", X, data.dtype, (s, n), data.device)
    b_ld = _check_lanes("B", B, data.dtype, (s, n), data.device)
    if inner_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_residual_lanes: inner dtype {inner_dtype} is not float32/float64")
    R = torch.empty((s, n), dtype=data.dtype, device=data.device)
    blocks = -(-n // lib.threads)
    p_ld = -(-2 * blocks // _PARTIALS_ALIGN) * _PARTIALS_ALIGN
    partials = torch.empty((s, p_ld), dtype=torch.float64, device=data.device)
    demote = int(inner_dtype == torch.float32 and data.dtype == torch.float64)
    for j, width in lane_chunks(s):
        lib.call(f"gmres_dia_residual_lanes_{sfx}", data.data_ptr(), X[j].data_ptr(), x_ld,
                 B[j].data_ptr(), b_ld, R[j].data_ptr(), n, partials[j].data_ptr(), p_ld, n, D,
                 offs, demote, width)
        dia_residual_cuda.launches += 1
        dia_residual_cuda.forms[f"{sfx}_lanes{width}"] += 1
    sums = torch.stack([p[:2 * blocks].view(blocks, 2).sum(dim=0) for p in partials])
    return R, sums[:, 0], sums[:, 1]
