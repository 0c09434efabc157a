"""Build the port's operators and preconditioners from plain numpy arrays.

These take the arrays of a ``gmres_tpu`` object, read out with
``np.asarray`` (for example ``np.asarray(A.data)`` of a DIA matrix), so that
both packages can run on one operator without this package importing the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from gmres_tpu_torch.ops.dia import DF64Dia, DIAMatrix
from gmres_tpu_torch.precond.build import ExactILUDIAPrec, ILUJacobiPrec, JacobiPrec
from gmres_tpu_torch.precond.level_ilu import LevelILUPrec
from gmres_tpu_torch.sparse import CSRMatrix, csr_from_arrays


def _tensor(a, device) -> torch.Tensor:
    """A writable copy of ``a`` as a tensor.  A JAX bf16 array read out with
    ``np.asarray`` has ``ml_dtypes``' 2-byte ``bfloat16`` dtype, which
    ``torch.from_numpy`` refuses: its bits move through a uint16 view, then
    int16 and a view as ``torch.bfloat16`` (no ``ml_dtypes`` import, no
    rounding)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def dia_from_numpy(data, offsets, n_rows: int, n_cols: int, nnz: int,
                   device="cpu") -> DIAMatrix:
    data = np.ascontiguousarray(np.asarray(data))
    if data.shape != (len(offsets), n_rows):
        raise ValueError(f"DIA data of shape {data.shape} for {len(offsets)} "
                         f"offsets and {n_rows} rows")
    return DIAMatrix(data=torch.from_numpy(data).to(device),
                     offsets=tuple(int(o) for o in offsets),
                     n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(nnz))


def df64_dia_from_numpy(data_hi, data_lo, offsets, n_rows: int, n_cols: int, nnz: int,
                        device="cpu") -> DF64Dia:
    """From the (hi, lo) fp32 band arrays of a JAX ``DF64Dia``."""
    hi, lo = (np.array(a, dtype=np.float32, order="C") for a in (data_hi, data_lo))
    if hi.shape != (len(offsets), n_rows) or lo.shape != hi.shape:
        raise ValueError(f"DF64 DIA bands of shapes {hi.shape}, {lo.shape} for "
                         f"{len(offsets)} offsets and {n_rows} rows")
    return DF64Dia(data_hi=torch.from_numpy(hi).to(device),
                   data_lo=torch.from_numpy(lo).to(device),
                   offsets=tuple(int(o) for o in offsets), n_rows=int(n_rows),
                   n_cols=int(n_cols), nnz=int(nnz))


def csr_from_numpy(row_ptr, col_idx, vals, n_cols: int | None = None,
                   device="cpu") -> CSRMatrix:
    """From CSR arrays (bf16 values as ``_tensor`` takes them); entries past
    ``row_ptr[-1]`` (the JAX package's padding) are dropped."""
    row_ptr = np.asarray(row_ptr)
    v = _tensor(np.asarray(vals)[: int(row_ptr[-1])], "cpu")
    return csr_from_arrays(row_ptr, np.asarray(col_idx), v, n_cols=n_cols).to(device)


def jacobi_from_numpy(inv_diag, device="cpu") -> JacobiPrec:
    return JacobiPrec(inv_diag=_tensor(inv_diag, device))


def ilu_jacobi_from_numpy(lower, upper, inv_diag, steps: int, device="cpu") -> ILUJacobiPrec:
    """From the CSR factors of a JAX ``ILUJacobiPrec``: ``lower`` and
    ``upper`` are (row_ptr, col_idx, vals) triples."""
    n = np.asarray(inv_diag).shape[0]
    lo, up = (csr_from_numpy(*tri, n_cols=n, device=device) for tri in (lower, upper))
    return ILUJacobiPrec(lower=lo, upper=up, inv_diag=_tensor(inv_diag, device),
                         steps=int(steps))


def exact_ilu_from_numpy(lower_bands, upper_bands, inv_diag, offs_l, offs_u,
                         steps_l: int, steps_u: int, seg: int = 0, steps_l_segs=(),
                         steps_u_segs=(), device="cpu") -> ExactILUDIAPrec:
    """From the arrays of a JAX ``ExactILUDIAPrec``, lane-padded bands
    (and, when segmented, their ``steps_*_segs``) as they are; on a CUDA
    device with the level schedule K6 runs, built from those bands."""
    return ExactILUDIAPrec(
        lower_bands=_tensor(lower_bands, "cpu"), upper_bands=_tensor(upper_bands, "cpu"),
        inv_diag=_tensor(inv_diag, "cpu"), offs_l=tuple(int(o) for o in offs_l),
        offs_u=tuple(int(o) for o in offs_u), steps_l=int(steps_l), steps_u=int(steps_u),
        seg=int(seg), steps_l_segs=tuple(int(s) for s in steps_l_segs),
        steps_u_segs=tuple(int(s) for s in steps_u_segs)).to(device)


def level_ilu_from_numpy(l_rows_max: int, u_rows_max: int, n: int, device="cpu",
                         **arrays) -> LevelILUPrec:
    """From the fields of a JAX ``LevelILUPrec`` (index arrays become
    int64, the sweep counts host ints)."""
    fields = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if name.endswith("_sweeps"):
            fields[name] = tuple(int(s) for s in a)
        else:
            fields[name] = _tensor(a.astype(np.int64) if a.dtype.kind == "i" else a, device)
    return LevelILUPrec(l_rows_max=int(l_rows_max), u_rows_max=int(u_rows_max), n=int(n),
                        **fields)
