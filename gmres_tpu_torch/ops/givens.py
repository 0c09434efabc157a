"""Givens rotations (BLAS rotg semantics) on small tensors.

The reference calls cblas_?rotg / cublas?rotg and zeroes the eliminated
entry (``kernels_mkl.cpp:217-218``).  Everything here works on 0-d tensors
or (m+1, m+1) matrices, or on a leading lane dimension for a batched
solve, that stay on the device: no value is read back to
the host, so the Arnoldi loop never waits on the card.
"""

from __future__ import annotations

import torch


def rotg(a: torch.Tensor, b: torch.Tensor):
    """BLAS ?rotg: (r, c, s) with [c s; -s c] @ [a; b] = [r; 0].

    r carries the sign of the larger-magnitude input; (c, s) = (1, 0) when
    both inputs are zero."""
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    abs_a, abs_b = torch.abs(a), torch.abs(b)
    roe = torch.where(abs_a > abs_b, a, b)
    scale = abs_a + abs_b
    safe_scale = torch.where(scale == 0, one, scale)
    r = safe_scale * torch.sqrt((a / safe_scale) ** 2 + (b / safe_scale) ** 2)
    r = torch.where(scale == 0, zero, torch.sign(roe) * r)
    safe_r = torch.where(r == 0, one, r)
    c = torch.where(scale == 0, one, a / safe_r)
    s = torch.where(scale == 0, zero, b / safe_r)
    return r, c, s


def accumulate_rotation(Q: torch.Tensor, k: int, c, s) -> torch.Tensor:
    """Q <- G(k, k+1; c, s) @ Q, in place: fold a new plane rotation into
    the accumulated orthogonal transform Q = G_{k-1} ... G_0, so that the
    Givens right-hand side is s = beta * Q[:, 0] (``gmres_tpu/ops/givens.py``).
    Q is (m+1, m+1) with 0-d c and s, or (lanes, m+1, m+1) with (lanes,)
    c and s (a batched solve; each lane's rows get the same elementwise
    arithmetic)."""
    c, s = c.unsqueeze(-1), s.unsqueeze(-1)
    qk, qk1 = Q[..., k, :].clone(), Q[..., k + 1, :].clone()
    Q[..., k, :] = c * qk + s * qk1
    Q[..., k + 1, :] = c * qk1 - s * qk
    return Q
