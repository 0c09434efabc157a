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
what the CPU path and the on-card comparisons use.

The kernel (redesigned for Hopper; K12, ``halo_kernel.py``, is the same
kernel with halo edges) sweeps blocks of ``block_rows`` rows, each thread
``rows_per_thread`` of them: an interior block, whose rows read x inside
[0, n_cols) for every band, takes a branch-free body, and the blocks within
max|offset| of either end the window path.  ``dia_plan`` is that split,
which the launcher checks against its own.  A launch takes 1 to 8 lanes
(``lane_chunks`` cuts wider batches) on the narrowest of ``LANE_WIDTHS``
that holds them, and counts into K1's wrappers as the form
``<dtype>_lanes<width>``.  y and r have the bits of one fused multiply-add
chain a row, bands in ascending order from 0, on every grid and for every
lane; the residual modes add their fp64 partials of each block in block
order inside the launch (K2's ticket), on the same blocks for every lane
count, so the sums are the same on every grid and lane l's are K1's on
x_l.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections import Counter

import torch

from gmres_tpu_torch.ops.cuda._build import check, kernel_dtype, library
from gmres_tpu_torch.ops.cuda.orth_kernel import _gram_state, sm_count

THREADS = 256  # csrc/common.cuh: kThreads
# lanes a launch's accumulators are compiled for (csrc/dia_spmv.cu:
# launch_dia); a launch of s <= 8 lanes runs on the narrowest that holds s
LANE_WIDTHS = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """The kernel's blocks of rows: block b owns rows [b * block_rows,
    min((b + 1) * block_rows, n)); blocks [b0, b1) are interior (each of
    their rows i reads x[i + off] inside [0, n_cols) for every band), the
    others take the window path.  A launch of G blocks sweeps blocks g, g +
    G, ...; the residual sums add the blocks' partials in block order."""

    n: int
    n_cols: int
    block_rows: int
    n_blocks: int
    b0: int
    b1: int

    def rows(self, b: int) -> range:
        return range(b * self.block_rows, min((b + 1) * self.block_rows, self.n))

    def interior(self, b: int) -> bool:
        return self.b0 <= b < self.b1


def rows_per_thread(itemsize: int, width: int = 1, residual: bool = False) -> int:
    """Rows a thread of a launch of ``width`` lanes owns
    (``csrc/dia_spmv.cu:dia_rows_per_thread``): a 16-byte chunk in residual
    mode, whatever the lanes (so every lane count sums the same blocks), and
    at one lane; in the plain lane form two rows, one fp64 row at 8 lanes
    (PERF.md, section 6)."""
    if residual or width == 1:
        return 16 // itemsize
    return 2 if itemsize == 4 or width <= 4 else 1


def dia_plan(offsets, n: int, n_cols: int, itemsize: int, rows: int | None = None,
             threads: int = THREADS) -> DiaPlan:
    """Blocks of ``threads`` times ``rows`` rows (by default a 16-byte chunk
    a thread); the interior range is the blocks whose first row is at least
    lo = max(0, -min offset) and whose end is at most n_cols - hi, hi =
    max(0, max offset) (``csrc/dia_spmv.cu:dia_interior``)."""
    if n < 1 or n_cols < 1:
        raise ValueError(f"K1: n={n}, n_cols={n_cols}")
    block_rows = threads * (rows or 16 // itemsize)
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    n_blocks = -(-n // block_rows)
    b0 = min(n_blocks, -(-lo // block_rows))
    room = n_cols - hi
    end = n_blocks if n <= room else max(0, room) // block_rows
    return DiaPlan(n=n, n_cols=n_cols, block_rows=block_rows, n_blocks=n_blocks, b0=b0,
                   b1=max(b0, end))


def lane_chunks(s: int) -> list:
    """(first lane, lanes) of each launch over s lanes: 8 lanes a launch,
    the rest in one."""
    return [(j, min(8, s - j)) for j in range(0, s, 8)]


def lane_width(lanes: int) -> int:
    """The narrowest of ``LANE_WIDTHS`` that holds ``lanes``."""
    return next(w for w in LANE_WIDTHS if w >= lanes)


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


def launch_spmv(lib, sfx, data, offs, plan, x, x_ld, y, y_ld, lanes, grid=None,
                left=None, right=None) -> None:
    """One launch of the kernel's plain mode over ``lanes`` lanes (x and y
    lane strides x_ld and y_ld), or over one lane and the halo edges."""
    hl, hr = (0, 0) if left is None else (left.shape[0], right.shape[0])
    lib.call(f"gmres_dia_spmv_{sfx}", data.data_ptr(), x.data_ptr(), x_ld,
             None if left is None else left.data_ptr(),
             None if right is None else right.data_ptr(), hl, hr, y.data_ptr(), y_ld, plan.n,
             plan.n_cols, data.shape[0], offs, lanes, plan.b0, plan.b1, grid or 0,
             sm_count(data.device))


def launch_residual(lib, sfx, data, offs, plan, x, x_ld, b, b_ld, r, r_ld, sums, demote, lanes,
                    grid=None, left=None, right=None) -> None:
    """One launch of the kernel's residual mode over ``lanes`` lanes (or one
    lane and the halo edges), the sums of squares into ``sums`` (lanes, 2)
    in fp64; it takes K2's ticket counter, so it keeps to K2's stream.  Its
    default grid is persistent: the kernel sizes it from the SM count given
    here."""
    sms, ticket = _gram_state(data.device)
    hl, hr = (0, 0) if left is None else (left.shape[0], right.shape[0])
    partials = torch.empty((lanes, plan.n_blocks, 2), dtype=torch.float64, device=data.device)
    lib.call(f"gmres_dia_residual_{sfx}", data.data_ptr(), x.data_ptr(), x_ld,
             None if left is None else left.data_ptr(),
             None if right is None else right.data_ptr(), hl, hr, b.data_ptr(), b_ld,
             r.data_ptr(), r_ld, partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(), plan.n,
             data.shape[0], offs, demote, lanes, plan.b0, plan.b1, grid or 0, sms)


def _demote(name: str, data: torch.Tensor, inner_dtype: torch.dtype) -> int:
    if inner_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: inner dtype {inner_dtype} is not float32/float64")
    return int(inner_dtype == torch.float32 and data.dtype == torch.float64)


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


def dia_spmv_cuda(data: torch.Tensor, offsets, x: torch.Tensor,
                  grid: int | None = None) -> torch.Tensor:
    """K1, plain mode; ``grid`` blocks (default: one a block of rows)."""
    lib, sfx, D, n, offs = _band_args("dia_spmv", data, offsets)
    n_cols = x.shape[0]
    check("x", x, data.dtype, (n_cols,), data.device)
    plan = dia_plan(offsets, n, n_cols, data.element_size(), threads=lib.threads)
    y = torch.empty(n, dtype=data.dtype, device=data.device)
    launch_spmv(lib, sfx, data, offs, plan, x, n_cols, y, n, 1, grid)
    dia_spmv_cuda.launches += 1
    dia_spmv_cuda.forms[sfx] += 1
    return y


dia_spmv_cuda.launches = 0
dia_spmv_cuda.forms = Counter()


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


def dia_spmv_lanes_cuda(data: torch.Tensor, offsets, X: torch.Tensor,
                        grid: int | None = None) -> torch.Tensor:
    """K1's lane form, plain mode: Y (s, n) contiguous from the lanes of X
    (s, n_cols), read in place at their stride, 8 lanes a launch."""
    lib, sfx, D, n, offs = _band_args("dia_spmv_lanes", data, offsets)
    if X.dim() != 2:
        raise ValueError(f"dia_spmv_lanes: X must be (lanes, n_cols), got {tuple(X.shape)}")
    s, n_cols = X.shape
    x_ld = _check_lanes("X", X, data.dtype, (s, n_cols), data.device)
    Y = torch.empty((s, n), dtype=data.dtype, device=data.device)
    for j, lanes in lane_chunks(s):
        plan = dia_plan(offsets, n, n_cols, data.element_size(),
                        rows_per_thread(data.element_size(), lane_width(lanes)), lib.threads)
        launch_spmv(lib, sfx, data, offs, plan, X[j], x_ld, Y[j], n, lanes, grid)
        dia_spmv_cuda.launches += 1
        dia_spmv_cuda.forms[f"{sfx}_lanes{lane_width(lanes)}"] += 1
    return Y


def dia_residual_plain(data, offsets, b, x, inner_dtype: torch.dtype):
    """(r, ||r'||^2, ||x||^2) for r = b - A x in A's dtype, where r' is r
    rounded to ``inner_dtype`` and its norm is taken in that dtype (the
    solver's start vector, ``gmres_tpu/solver/gmres.py:489-504``)."""
    r = b - dia_spmv_plain(data, offsets, x)
    ri = r.to(inner_dtype)
    return r, torch.dot(ri, ri).to(torch.float64), torch.dot(x, x).to(torch.float64)


def dia_residual_cuda(data, offsets, b, x, inner_dtype: torch.dtype, grid: int | None = None):
    """K1, residual mode: r in A's dtype and the two sums of squares, fp64
    partials of each block that the launch adds in block order (one launch,
    the same bits on every ``grid``; by default a persistent grid)."""
    lib, sfx, D, n, offs = _band_args("dia_residual", data, offsets)
    check("b", b, data.dtype, (n,), data.device)
    check("x", x, data.dtype, (n,), data.device)
    demote = _demote("dia_residual", data, inner_dtype)
    plan = dia_plan(offsets, n, n, data.element_size(), threads=lib.threads)
    r = torch.empty(n, dtype=data.dtype, device=data.device)
    sums = torch.empty(2, dtype=torch.float64, device=data.device)
    launch_residual(lib, sfx, data, offs, plan, x, n, b, n, r, n, sums, demote, 1, grid)
    dia_residual_cuda.launches += 1
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


def dia_residual_lanes_cuda(data, offsets, B, X, inner_dtype: torch.dtype,
                            grid: int | None = None):
    """K1's lane form, residual mode: R (s, n) contiguous and each lane's
    two sums of squares, each lane's bits those of ``dia_residual_cuda`` on
    it; 8 lanes a launch, each launch one kernel that adds its lanes' sums."""
    lib, sfx, D, n, offs = _band_args("dia_residual_lanes", data, offsets)
    s = X.shape[0]
    x_ld = _check_lanes("X", X, data.dtype, (s, n), data.device)
    b_ld = _check_lanes("B", B, data.dtype, (s, n), data.device)
    demote = _demote("dia_residual_lanes", data, inner_dtype)
    plan = dia_plan(offsets, n, n, data.element_size(), threads=lib.threads)
    R = torch.empty((s, n), dtype=data.dtype, device=data.device)
    sums = torch.empty((s, 2), dtype=torch.float64, device=data.device)
    for j, lanes in lane_chunks(s):
        launch_residual(lib, sfx, data, offs, plan, X[j], x_ld, B[j], b_ld, R[j], n, sums[j],
                        demote, lanes, grid)
        dia_residual_cuda.launches += 1
        dia_residual_cuda.forms[f"{sfx}_lanes{lane_width(lanes)}"] += 1
    return R, sums[:, 0], sums[:, 1]
