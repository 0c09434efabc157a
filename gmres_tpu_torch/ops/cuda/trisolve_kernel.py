"""K6 wrappers: the exact-ILU triangular-solve kernel (``csrc/ilu_trisolve.cu``)
in its fused and segmented forms, each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/trisolve_kernel.py``'s ``ilu_trisolve_fused``
and ``ilu_trisolve_segmented``.  With strictly-triangular DIA bands ``ld``
(lower offsets) and ``ud`` (upper offsets), each of shape (>= D, width), and
the inverse diagonal ``invd`` (width,):

    L phase:  steps_l sweeps  x <- w  - L_s x,          from x = w
    U phase:  steps_u sweeps  x <- D^-1 (b' - U_s x),   from x = b' (the L result)

x[j] is read as 0 outside [0, width).  The segmented form runs the L sweeps
segment by segment in forward order and the U sweeps in reverse order, rows
[c*seg, (c+1)*seg) of segment c, ``steps_*_segs[c]`` sweeps each; rows of
other segments keep their values (final ones, for the neighbour a triangle
reads).  ``w`` may be shorter than ``width`` (the JAX package's lane-padded
factors): it is padded with zeros and the result cut back to its length.

The ``*_cuda`` wrappers take CUDA tensors only, make one cooperative launch
per apply and raise on anything the kernel does not take or a refused
launch; the ``*_plain`` versions run on any device (double-buffered sweeps
in torch ops) and are what the CPU path and the on-card comparisons use.
"""

from __future__ import annotations

import ctypes

import torch

from gmres_tpu_torch.ops.cuda._build import check, kernel_dtype, library

MAX_BANDS = 64       # bands per triangle (kMaxTriDiags in the source)
MAX_SEGMENTS = 256   # segments of the segmented form (kMaxSegs)


def _padded(w: torch.Tensor, width: int) -> torch.Tensor:
    if w.shape[0] == width:
        return w
    out = torch.zeros(width, dtype=w.dtype, device=w.device)
    out[: w.shape[0]] = w
    return out


def _band_sum(bands, offs, x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """sum_d bands[d, i] * x[i + offs[d]] for rows i in [a, b), in band
    order, with x read as 0 outside [0, len(x))."""
    n = x.shape[0]
    acc = torch.zeros(b - a, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offs):
        lo, hi = max(a, -off), min(b, n - off)
        if hi > lo:
            acc[lo - a:hi - a] += bands[d, lo:hi] * x[lo + off:hi + off]
    return acc


def ilu_trisolve_segmented_plain(ld, ud, invd, w, offs_l, offs_u, steps_l_segs,
                                 steps_u_segs, seg: int) -> torch.Tensor:
    """x = U^-1 L^-1 w segment by segment, each sweep double-buffered
    within its segment."""
    width = invd.shape[0]
    n_in = w.shape[0]
    w = _padded(w, width)
    bounds = [(a, min(a + seg, width)) for a in range(0, width, seg)]
    x = w.clone()
    if offs_l:
        for (a, b), steps in zip(bounds, steps_l_segs):
            for _ in range(steps):
                x[a:b] = w[a:b] - _band_sum(ld, offs_l, x, a, b)
    b2 = x.clone()
    if not offs_u:
        return (invd * b2)[:n_in]
    for (a, b), steps in reversed(list(zip(bounds, steps_u_segs))):
        for _ in range(steps):
            x[a:b] = invd[a:b] * (b2[a:b] - _band_sum(ud, offs_u, x, a, b))
    return x[:n_in]


def ilu_trisolve_fused_plain(ld, ud, invd, w, offs_l, offs_u, steps_l: int,
                             steps_u: int) -> torch.Tensor:
    """x = U^-1 L^-1 w, every sweep over the whole vector: the segmented
    solve with one segment."""
    width = invd.shape[0]
    return ilu_trisolve_segmented_plain(ld, ud, invd, w, offs_l, offs_u, (steps_l,),
                                        (steps_u,), max(width, 1))


def _launch(name, ld, ud, invd, w, offs_l, offs_u, seg, steps_l_segs, steps_u_segs):
    """Validate (before anything is built), launch once, return x."""
    sfx = kernel_dtype(name, invd)
    width = invd.shape[0] if invd.dim() == 1 else 0
    dev = invd.device
    check("invd", invd, invd.dtype, (width,), dev)
    if width < 1 or not 0 < w.shape[0] <= width:
        raise ValueError(f"{name}: {w.shape[0]} rows of w for factors of width {width}")
    check("w", w, invd.dtype, (w.shape[0],), dev)
    for label, bands, offs in (("ld", ld, offs_l), ("ud", ud, offs_u)):
        if len(offs) > MAX_BANDS or bands.dim() != 2 or bands.shape[0] < len(offs):
            raise ValueError(f"{name}: {label} of shape {tuple(bands.shape)} for "
                             f"{len(offs)} offsets; the kernel takes up to {MAX_BANDS}")
        check(label, bands, invd.dtype, (bands.shape[0], width), dev)
    n_seg = -(-width // seg)
    if not (0 < n_seg <= MAX_SEGMENTS and len(steps_l_segs) == len(steps_u_segs) == n_seg):
        raise ValueError(f"{name}: {n_seg} segments of {seg} rows and "
                         f"{len(steps_l_segs)}/{len(steps_u_segs)} step counts; the "
                         f"kernel takes up to {MAX_SEGMENTS}")
    lib = library()
    w = _padded(w, width)
    x = torch.empty(width, dtype=invd.dtype, device=dev)
    b2 = torch.empty(width if offs_u else 1, dtype=invd.dtype, device=dev)

    def ints(v):
        return (ctypes.c_int * max(len(v), 1))(*v)

    blocks = ctypes.c_int(0)
    lib.call(f"gmres_ilu_trisolve_{sfx}", ld.data_ptr(), ud.data_ptr(), invd.data_ptr(),
             w.data_ptr(), x.data_ptr(), b2.data_ptr(), width, len(offs_l), ints(offs_l),
             len(offs_u), ints(offs_u), seg, n_seg, ints(steps_l_segs),
             ints(steps_u_segs), ctypes.addressof(blocks))
    return x, blocks.value


def ilu_trisolve_fused_cuda(ld, ud, invd, w, offs_l, offs_u, steps_l: int,
                            steps_u: int) -> torch.Tensor:
    """K6, fused: one cooperative launch over the whole vector."""
    width = invd.shape[0]
    x, ilu_trisolve_fused_cuda.grid = _launch(
        "ilu_trisolve_fused", ld, ud, invd, w, offs_l, offs_u, max(width, 1),
        (steps_l,), (steps_u,))
    ilu_trisolve_fused_cuda.launches += 1
    return x[: w.shape[0]]


ilu_trisolve_fused_cuda.launches = 0
ilu_trisolve_fused_cuda.grid = 0


def ilu_trisolve_segmented_cuda(ld, ud, invd, w, offs_l, offs_u, steps_l_segs,
                                steps_u_segs, seg: int) -> torch.Tensor:
    """K6, segmented: one cooperative launch sweeping segment by segment."""
    if seg < 1:
        raise ValueError(f"ilu_trisolve_segmented: segment of {seg} rows")
    x, ilu_trisolve_segmented_cuda.grid = _launch(
        "ilu_trisolve_segmented", ld, ud, invd, w, offs_l, offs_u, seg,
        tuple(steps_l_segs), tuple(steps_u_segs))
    ilu_trisolve_segmented_cuda.launches += 1
    return x[: w.shape[0]]


ilu_trisolve_segmented_cuda.launches = 0
ilu_trisolve_segmented_cuda.grid = 0
