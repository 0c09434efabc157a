"""Small dense triangular solve with an active size that lives on the
device.

The reference calls cblas_?trsv on the leading k-by-k block of the
Hessenberg matrix (``gmres.cpp:288,300``).  Here k (the happy-breakdown
bound ``kdim``) is a 0-d tensor, so the full m-by-m system is solved with
inactive rows and columns replaced by the identity and a zero right-hand
side: algebraically the k-by-k solve, with y[j] = 0 for j >= k, and no
read of k on the host.
"""

from __future__ import annotations

import torch


def trsv_upper_padded(H: torch.Tensor, s: torch.Tensor, k) -> torch.Tensor:
    """Solve H[:k,:k] y = s[:k]; H (m, m), s (m,); returns y (m,) with
    zeros past k.  Column-sweep back-substitution over the static m, the
    operation order of ``gmres_tpu/ops/tri.py``.  With a leading lane
    dimension (H (lanes, m, m), s (lanes, m), k (lanes,)) each lane is
    solved to its own k with the same elementwise arithmetic."""
    m = H.shape[-1]
    idx = torch.arange(m, device=H.device)
    i, j = idx[:, None], idx[None, :]
    kv = torch.as_tensor(k, device=H.device).unsqueeze(-1)   # (..., 1)
    km = kv.unsqueeze(-1)                                    # (..., 1, 1)
    active = (i < km) & (j < km)
    Hp = torch.where(active, H, torch.zeros_like(H)) + ((i == j) & (i >= km)).to(H.dtype)
    y = torch.where(idx < kv, s, torch.zeros_like(s))
    # unguarded reciprocal: a zero pivot surfaces as inf/NaN exactly like
    # the reference's trsv division
    dinv = 1.0 / torch.diagonal(Hp, dim1=-2, dim2=-1)
    for col in range(m - 1, -1, -1):
        y_col = y[..., col] * dinv[..., col]
        if col:
            y[..., :col] -= y_col.unsqueeze(-1) * Hp[..., :col, col]
        y[..., col] = y_col
    return y
