"""Double-float (two-fp32) arithmetic on tensors: the error-free transforms
of ``gmres_tpu/ops/pallas/df64_kernel.py:52-99`` and the pair reductions
that the df64 kernels' plain versions are built from.

A double-float value is an unevaluated pair (hi, lo) of fp32 tensors with
hi + lo the value and |lo| <= ulp(hi)/2, about 2^-48 relative.  Every
function here is a chain of single torch ops, each rounded on its own
(eager PyTorch never contracts ``a * b + c`` into a fused multiply-add),
so the Veltkamp ``two_prod`` is exact as in the JAX package.  The CUDA
kernels (``csrc/df64.cuh``) compute the same chains with ``__fadd_rn``,
``__fmul_rn`` and an FMA-based ``two_prod``, which gives the same pair.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0  # 2^12 + 1: Veltkamp split of an fp32 significand


def split_f64(x: torch.Tensor):
    """fp64 -> (hi, lo) fp32 pair with hi + lo == x up to the rounding of
    the tail."""
    hi = x.to(torch.float32)
    lo = (x - hi.to(x.dtype)).to(torch.float32)
    return hi, lo


def merge_f64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi.to(torch.float64) + lo.to(torch.float64)


def two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def two_prod(a, b):
    p = a * b
    ca = _SPLIT * a
    a_hi = ca - (ca - a)
    a_lo = a - a_hi
    cb = _SPLIT * b
    b_hi = cb - (cb - b)
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def df_mul(ah, al, bh, bl):
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return quick_two_sum(p, e)


def df_add(ah, al, bh, bl):
    s, e = two_sum(ah, bh)
    e = e + al + bl
    return quick_two_sum(s, e)


def df_sum(h: torch.Tensor, l: torch.Tensor, dim: int = -1):
    """Sum along ``dim`` by a pairwise halving tree of pair additions over
    the length padded with zeros to a power of two (element i meets element
    i + half at each level), as ``gmres_tpu/ops/df64.py:df_sum``."""
    h = h.movedim(dim, -1)
    l = l.movedim(dim, -1)
    n = h.shape[-1]
    p = 1 << max(0, (n - 1).bit_length())
    if p != n:
        h = torch.nn.functional.pad(h, (0, p - n))
        l = torch.nn.functional.pad(l, (0, p - n))
    while h.shape[-1] > 1:
        half = h.shape[-1] // 2
        h, l = df_add(h[..., :half], l[..., :half], h[..., half:], l[..., half:])
    return h[..., 0], l[..., 0]


def df_basis_comb(Vh, Vl, y64: torch.Tensor):
    """sum_j y_j V_j over the rows of the pair basis (Vh, Vl), y fp64 and
    split per coefficient, accumulated row by row in row order from a zero
    pair: the order of kernels K10 and K11 (``csrc/df64_sweep.cu``)."""
    yh, yl = split_f64(y64)
    ch = torch.zeros(Vh.shape[1], dtype=torch.float32, device=Vh.device)
    cl = torch.zeros_like(ch)
    for j in range(Vh.shape[0]):
        ph, pl = df_mul(Vh[j], Vl[j], yh[j], yl[j])
        ch, cl = df_add(ch, cl, ph, pl)
    return ch, cl
