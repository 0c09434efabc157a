"""K6 wrappers: the exact-ILU triangular-solve kernel (``csrc/ilu_trisolve.cu``)
in its fused and segmented forms, each beside its plain PyTorch version,
and the level schedule the kernel runs.

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
The step counts are the triangles' dependency-level counts (per segment:
the intra-segment ones), at which the sweeps reach the exact substitution.

The kernel computes that exact result with each row once, level by level,
from a ``LevelSchedule`` built once per preconditioner on the host
(``level_schedule``, when ``ExactILUDIAPrec.to`` moves it to the card):
each row is computed from final inputs in band order,
which is the value the sweeps leave in it, so the kernel, its plain
versions and the level-ordered twin ``ilu_trisolve_levels_plain`` give the
same bits, and the fused and segmented forms are one launch of the same
schedule (the global levels: fewer steps than a segment's own).

The ``*_cuda`` wrappers take CUDA tensors and the schedule only, gather w
into level order and make one kernel launch per apply, and raise on step
counts short of the schedule's levels (the sweeps would stop short of the
exact solve the kernel computes), on anything the kernel does not take and
on a refused launch; the ``*_plain`` versions run on any device
(double-buffered sweeps in torch ops) and are what the CPU path and the
on-card comparisons use.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.ops.cuda._build import check, host_library, kernel_dtype, library

LEVEL_THREADS = 1024      # threads per block (kLevelThreads)
SYNC_MODES = {"block": 0, "grid": 1}
# the barriers level_sync_probe measures: the kernel's two and a cluster's
PROBE_MODES = {**SYNC_MODES, "cluster": 2}


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


# ------------------------------------------------------------ level schedule


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """Each triangle's rows in dependency-level order (``rows_*``, int32),
    its level pointers (``ptr_*``, int32, levels + 1), its bands repacked in
    that order (``bands_*[d, p] = bands[d, rows_*[p]]``) and the level-order
    position of each band's row (``dep_*[d, p]``, int32; -1 where that row
    is outside the width or the band's value there is a stored zero);
    ``upos_l`` is the U position of the row at each L
    position and ``invd_u`` D^-1 in the U order.  ``nlev_*`` and ``width_*``
    (the widest level) are host ints, which size the kernel's grid; with
    ``seg`` > 0, ``seg_levels_*`` are the level counts within each segment of
    ``seg`` rows (the segmented sweeps' exact step counts)."""

    rows_l: torch.Tensor
    ptr_l: torch.Tensor
    bands_l: torch.Tensor
    dep_l: torch.Tensor
    rows_u: torch.Tensor
    ptr_u: torch.Tensor
    bands_u: torch.Tensor
    dep_u: torch.Tensor
    upos_l: torch.Tensor
    invd_u: torch.Tensor
    nlev_l: int
    nlev_u: int
    width_l: int
    width_u: int
    seg: int = 0
    seg_levels_l: tuple = ()
    seg_levels_u: tuple = ()

    def to(self, device) -> "LevelSchedule":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def band_levels(bands: np.ndarray, offs, upper: bool, seg: int = 0) -> tuple[np.ndarray, int]:
    """Per-row dependency levels of one strict triangle from its DIA bands
    (row i depends on i + offs[d] where bands[d, i] != 0 and that row lies
    in the band width and, with seg > 0, in row i's segment of seg rows) and
    the level count, through the host helper."""
    width = bands.shape[1]
    nonzero = np.ascontiguousarray(bands[: len(offs)] != 0, dtype=np.uint8)
    offs64 = np.ascontiguousarray(offs, dtype=np.int64)
    lev = np.empty(width, dtype=np.int64)
    count = host_library().ilu_host_dia_levels(width, len(offs), offs64.ctypes.data,
                                               nonzero.ctypes.data, int(upper), seg,
                                               lev.ctypes.data)
    if count < 0:
        raise ValueError(f"{'upper' if upper else 'lower'} band offsets {tuple(offs)} are "
                         "not all on that side of the diagonal")
    return lev, int(count)


def _level_order(lev: np.ndarray, count: int):
    """(rows in level order, ties by row; level pointers; widest level)."""
    rows = np.argsort(lev, kind="stable")
    sizes = np.bincount(lev, minlength=count)
    ptr = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(sizes, out=ptr[1:])
    return rows, ptr, int(sizes.max())


def level_schedule(ld, ud, invd, offs_l, offs_u, seg: int = 0) -> LevelSchedule:
    """The level schedule of the factors (host, setup time), with each
    segment's own level counts for segments of ``seg`` rows.  Built from the
    bands themselves, so that a converted JAX state (lane-padded width,
    identity tail segments) gets one too."""
    width = invd.shape[0]
    if width >= 2 ** 31:
        raise ValueError(f"level schedule: {width} rows do not fit int32 indices")
    out = {"seg": seg}
    for tag, bands, offs, upper in (("l", ld, offs_l, False), ("u", ud, offs_u, True)):
        b = bands.cpu().numpy()[: len(offs)]
        lev, count = band_levels(b, offs, upper)
        if seg > 0:
            seg_lev, _ = band_levels(b, offs, upper, seg)
            out[f"seg_levels_{tag}"] = tuple(
                int(c) + 1 for c in np.maximum.reduceat(seg_lev, np.arange(0, width, seg)))
        rows, ptr, widest = _level_order(lev, count)
        pos = np.empty(width, dtype=np.int64)
        pos[rows] = np.arange(width)
        # a band's stored zero is no neighbour: 0 times a finite value adds
        # nothing to the sum, and at a grid's edges such a band points at a
        # row of a later level, which the kernel would read from device memory
        dep = np.full((len(offs), width), -1, dtype=np.int32)
        for d, off in enumerate(offs):
            j = rows + off
            live = (j >= 0) & (j < width) & (b[d, rows] != 0)
            dep[d, live] = pos[j[live]]
        out[f"pos_{tag}"] = pos
        out[f"rows_{tag}"] = torch.from_numpy(rows.astype(np.int32))
        out[f"ptr_{tag}"] = torch.from_numpy(ptr.astype(np.int32))
        out[f"bands_{tag}"] = torch.from_numpy(np.ascontiguousarray(b[:, rows]))
        out[f"dep_{tag}"] = torch.from_numpy(dep)
        out[f"nlev_{tag}"] = count
        out[f"width_{tag}"] = widest
    out["invd_u"] = torch.from_numpy(np.ascontiguousarray(
        invd.cpu().numpy()[out["rows_u"].numpy()]))
    out["upos_l"] = torch.from_numpy(out.pop("pos_u")[out["rows_l"].numpy()].astype(np.int32))
    del out["pos_l"]
    return LevelSchedule(**out)


def ilu_trisolve_levels_plain(S: LevelSchedule, w: torch.Tensor) -> torch.Tensor:
    """The kernel's data path in torch ops, level by level on schedule S:
    xl = w in L order; each L level r = xl[p] - sum_d bands_l[d, p] xl[dep_l[d,
    p]] into xl[p] and xu[upos_l[p]]; each U level r = invd_u[p] (xu[p] - sum_d
    bands_u[d, p] xu[dep_u[d, p]]) into xu[p] and x[rows_u[p]]; terms with no
    neighbour (-1: outside the width, or a stored zero band) left out.  The
    same bits as the sweeps wherever the values are finite (a stored zero
    times a finite value adds nothing); where a value read through a zero
    band is not, the sweeps give NaN in that row and this does not."""
    width = S.invd_u.shape[0]
    n_in = w.shape[0]
    xl = _padded(w, width)[S.rows_l.long()]
    xu = torch.empty_like(xl)
    x = torch.empty_like(xl)

    def phase(ptr, bands, dep, out, invd, xs, xo):
        ptr = ptr.tolist()
        for k in range(len(ptr) - 1):
            p = slice(ptr[k], ptr[k + 1])
            acc = torch.zeros(ptr[k + 1] - ptr[k], dtype=xs.dtype, device=xs.device)
            for d in range(bands.shape[0]):
                q = dep[d, p].long()
                acc = torch.where(q >= 0, acc + bands[d, p] * xs[q.clamp(min=0)], acc)
            r = xs[p] - acc if invd is None else invd[p] * (xs[p] - acc)
            xs[p] = r
            xo[out[p].long()] = r

    phase(S.ptr_l, S.bands_l, S.dep_l, S.upos_l, None, xl, xu)
    phase(S.ptr_u, S.bands_u, S.dep_u, S.rows_u, S.invd_u, xu, x)
    return x[:n_in]


def level_grid(widest: int) -> tuple[str, int]:
    """The kernel's sync mode and blocks for a widest level of this many
    rows: one block while it fits one, else a cooperative grid (cut to the
    resident blocks at launch)."""
    blocks = max(1, -(-widest // LEVEL_THREADS))
    return ("block", 1) if blocks == 1 else ("grid", blocks)


# ------------------------------------------------------------------- launch


def _launch(name, ld, ud, invd, w, offs_l, offs_u, S, sync, steps_l, steps_u, seg=0):
    """Validate (before anything is built), launch once, return x and the
    grid it ran on.  The step counts (one a segment of ``seg`` rows, or one
    for the whole triangle) must reach the schedule's level counts: the
    kernel computes the exact solve, and fewer sweeps are not that solve."""
    if sync is not None and not (
            isinstance(sync, tuple) and len(sync) == 2 and sync[0] in SYNC_MODES
            and isinstance(sync[1], int) and sync[1] >= 1
            and (sync[0] != "block" or sync[1] == 1)):
        raise ValueError(f"{name}: sync {sync!r} is neither ('block', 1) nor "
                         "('grid', blocks >= 1)")
    sfx = kernel_dtype(name, invd)
    width = invd.shape[0] if invd.dim() == 1 else 0
    dev = invd.device
    check("invd", invd, invd.dtype, (width,), dev)
    if width < 1 or not 0 < w.shape[0] <= width:
        raise ValueError(f"{name}: {w.shape[0]} rows of w for factors of width {width}")
    check("w", w, invd.dtype, (w.shape[0],), dev)
    for label, bands, offs in (("ld", ld, offs_l), ("ud", ud, offs_u)):
        if bands.dim() != 2 or bands.shape[0] < len(offs):
            raise ValueError(f"{name}: {label} of shape {tuple(bands.shape)} for "
                             f"{len(offs)} offsets")
        check(label, bands, invd.dtype, (bands.shape[0], width), dev)
    if not isinstance(S, LevelSchedule):
        raise TypeError(f"{name}: schedule is the preconditioner's LevelSchedule "
                        f"(M.schedule), not {type(S).__name__}")
    if S.seg != seg:
        raise ValueError(f"{name}: a schedule for segments of {S.seg} rows, not {seg}")
    levels_l, levels_u = ((S.seg_levels_l, S.seg_levels_u) if seg
                          else ((S.nlev_l,), (S.nlev_u,)))
    short_l = bool(offs_l) and any(s < k for s, k in zip(steps_l, levels_l))
    if short_l or any(s < k for s, k in zip(steps_u, levels_u)):
        raise ValueError(f"{name}: sweeps {tuple(steps_l)}/{tuple(steps_u)} short of the "
                         f"dependency levels {levels_l}/{levels_u}")
    for tag, d in (("l", len(offs_l)), ("u", len(offs_u))):
        nlev = getattr(S, f"nlev_{tag}")
        check(f"rows_{tag}", getattr(S, f"rows_{tag}"), torch.int32, (width,), dev)
        check(f"ptr_{tag}", getattr(S, f"ptr_{tag}"), torch.int32, (nlev + 1,), dev)
        check(f"bands_{tag}", getattr(S, f"bands_{tag}"), invd.dtype, (d, width), dev)
        check(f"dep_{tag}", getattr(S, f"dep_{tag}"), torch.int32, (d, width), dev)
    check("invd_u", S.invd_u, invd.dtype, (width,), dev)
    check("upos_l", S.upos_l, torch.int32, (width,), dev)
    mode, blocks = sync or level_grid(max(S.width_l if offs_l else 0, S.width_u))
    lib = library()
    # w in L order (the kernel's own values), scratch for the U order, x
    xl = _padded(w, width).index_select(0, S.rows_l)
    xu = torch.empty_like(xl)
    x = torch.empty_like(xl)
    grid = ctypes.c_int(blocks)
    lib.call(f"gmres_ilu_levels_{sfx}", S.ptr_l.data_ptr(), S.bands_l.data_ptr(),
             S.dep_l.data_ptr(), S.upos_l.data_ptr(), S.nlev_l, len(offs_l),
             S.ptr_u.data_ptr(), S.bands_u.data_ptr(), S.dep_u.data_ptr(), S.rows_u.data_ptr(),
             S.invd_u.data_ptr(), S.nlev_u, len(offs_u), xl.data_ptr(), xu.data_ptr(),
             x.data_ptr(), width, SYNC_MODES[mode], ctypes.addressof(grid))
    return x[: w.shape[0]], (mode, grid.value)


def ilu_trisolve_fused_cuda(ld, ud, invd, w, offs_l, offs_u, steps_l: int, steps_u: int, *,
                            schedule: LevelSchedule, sync: tuple | None = None) -> torch.Tensor:
    """K6, fused: one launch of the preconditioner's level ``schedule``.
    ``sync`` = (mode, blocks) overrides the grid ``level_grid`` picks (for
    timing the kernel's two forms); the grid it ran on is left in
    ``ilu_trisolve_fused_cuda.grid``."""
    x, ilu_trisolve_fused_cuda.grid = _launch("ilu_trisolve_fused", ld, ud, invd, w, offs_l,
                                              offs_u, schedule, sync, (steps_l,), (steps_u,))
    ilu_trisolve_fused_cuda.launches += 1
    return x


ilu_trisolve_fused_cuda.launches = 0
ilu_trisolve_fused_cuda.grid = ("block", 0)


def ilu_trisolve_segmented_cuda(ld, ud, invd, w, offs_l, offs_u, steps_l_segs,
                                steps_u_segs, seg: int, *,
                                schedule: LevelSchedule) -> torch.Tensor:
    """K6, segmented: the same launch as the fused form (the global levels
    give the segment-by-segment sweeps' bits in fewer steps), on a schedule
    built for segments of ``seg`` rows, whose own level counts the step
    counts are held to."""
    name = "ilu_trisolve_segmented"
    width = invd.shape[0] if invd.dim() == 1 else 0
    n_seg = -(-width // seg) if seg >= 1 else 0
    if not (0 < n_seg and len(steps_l_segs) == len(steps_u_segs) == n_seg):
        raise ValueError(f"{name}: {n_seg} segments of {seg} rows and "
                         f"{len(steps_l_segs)}/{len(steps_u_segs)} step counts")
    x, ilu_trisolve_segmented_cuda.grid = _launch(name, ld, ud, invd, w, offs_l, offs_u,
                                                  schedule, None, steps_l_segs, steps_u_segs,
                                                  seg)
    ilu_trisolve_segmented_cuda.launches += 1
    return x


ilu_trisolve_segmented_cuda.launches = 0
ilu_trisolve_segmented_cuda.grid = ("block", 0)


def level_sync_probe(mode: str, blocks: int, syncs: int) -> int:
    """Launch ``syncs`` empty barriers of sync mode ``mode`` on ``blocks``
    blocks of LEVEL_THREADS (for timing one barrier); returns the blocks
    used (a cooperative grid is cut to the resident blocks)."""
    out = ctypes.c_int(0)
    library().call("gmres_level_sync_probe", PROBE_MODES[mode], blocks, syncs,
                   ctypes.addressof(out))
    return out.value
