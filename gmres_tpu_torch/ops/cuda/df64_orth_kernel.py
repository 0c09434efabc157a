"""K9-K11 wrappers: the sweeps over the double-float Krylov basis of a df64
solve (``csrc/df64_sweep.cu``), each beside its plain PyTorch version.

Replaces ``gmres_tpu/ops/pallas/df64_kernel.py``'s ``df_gram_pallas``,
``df_update_gram_pallas`` and ``df_update_sumsq_pallas``:

    df_gram:          u = V w
    df_update_gram:   w' = w - u^T V,  u2 = V w'
    df_update_sumsq:  w' = w - u^T V,  ||w'||^2

``(Vh, Vl)`` is the (m+1, n) basis as fp32 pairs, ``(wh, wl)`` a pair
vector, ``u`` an fp64 (m+1,) vector; u, u2 and the sum of squares come back
in fp64, w' as a pair.  Only the first ``rows`` rows are read (the solver
passes rows = k + 1, as for K2/K3), and u and u2 keep the full (m+1,)
length with zeros past ``rows``.  A one-row basis (``Vh[j:j+1]``) gives the
df64 dot, norm and one MGS row.

The plain versions are ``gmres_tpu/ops/df64.py``'s pair algebra: products
by ``df_mul``, sums over n by the halving tree ``df_sum``, and the
combination u^T V row by row (``eft.df_basis_comb``).  The kernels sum over
n in another order (per-thread, warp tree, per-block or per-tile partials
folded in fp64), so u, u2 and the sum of squares agree to rounding; w' is
the same chain and agrees bit for bit.

K10 (redesigned for Hopper) is one launch: a persistent grid over tiles of
whole 128-byte lines that ``df_update_gram_plan`` sizes so that a ring of
two stages (each the tile's 2 x rows basis rows and w's pair) and u fit
the block's shared memory; the last block adds the tiles' partials, so its
bits do not depend on the grid.
"""

from __future__ import annotations

import dataclasses

import torch

from gmres_tpu_torch.ops.cuda._build import check, library
from gmres_tpu_torch.ops.cuda.orth_kernel import (
    BLOCK_RESERVED_BYTES,
    SM_SHARED_BYTES,
    GramPlan,
    _gram_state,
)
from gmres_tpu_torch.ops.eft import df_add, df_basis_comb, df_mul, df_sum, merge_f64

_f32, _f64 = torch.float32, torch.float64


def _rows_ok(Vh: torch.Tensor, rows: int) -> None:
    if Vh.dim() != 2 or not 1 <= rows <= Vh.shape[0]:
        raise ValueError(f"rows={rows} outside 1..{Vh.shape[0]} for a basis of shape "
                         f"{tuple(Vh.shape)}")


def _sweep_args(name: str, Vh, Vl, rows: int, wh, wl, u=None):
    """Validate a sweep's arguments (before anything is built); return
    (library, m+1, n, number of blocks)."""
    if Vh.dtype != _f32:
        raise TypeError(f"{name}: the basis is fp32 pairs, got {Vh.dtype}")
    _rows_ok(Vh, rows)
    m1, n = Vh.shape
    dev = Vh.device
    check("Vh", Vh, _f32, (m1, n), dev)
    check("Vl", Vl, _f32, (m1, n), dev)
    check("wh", wh, _f32, (n,), dev)
    check("wl", wl, _f32, (n,), dev)
    if u is not None:
        check("u", u, _f64, (m1,), dev)
    lib = library()
    if m1 > lib.max_rows:
        raise ValueError(f"{name}: basis height {m1} > {lib.max_rows}")
    return lib, m1, n, -(-n // lib.tile)


def _padded(v: torch.Tensor, m1: int) -> torch.Tensor:
    out = torch.zeros(m1, dtype=_f64, device=v.device)
    out[:v.shape[0]] = v
    return out


def df_gram_plain(Vh, Vl, wh, wl, rows: int) -> torch.Tensor:
    _rows_ok(Vh, rows)
    ph, pl = df_mul(Vh[:rows], Vl[:rows], wh, wl)
    return _padded(merge_f64(*df_sum(ph, pl)), Vh.shape[0])


def df_gram_cuda(Vh, Vl, wh, wl, rows: int) -> torch.Tensor:
    """K9: u = V w from per-block fp64 partials."""
    lib, m1, n, nb = _sweep_args("df_gram", Vh, Vl, rows, wh, wl)
    partials = torch.empty((nb, m1), dtype=_f64, device=Vh.device)
    lib.call("gmres_df_gram", Vh.data_ptr(), Vl.data_ptr(), wh.data_ptr(), wl.data_ptr(),
             partials.data_ptr(), n, rows, m1)
    df_gram_cuda.launches += 1
    return partials.sum(dim=0)


df_gram_cuda.launches = 0


def _update_plain(Vh, Vl, wh, wl, u, rows: int):
    _rows_ok(Vh, rows)
    ch, cl = df_basis_comb(Vh[:rows], Vl[:rows], u[:rows])
    return df_add(wh, wl, -ch, -cl)


def df_update_gram_plain(Vh, Vl, wh, wl, u, rows: int):
    woh, wol = _update_plain(Vh, Vl, wh, wl, u, rows)
    return woh, wol, df_gram_plain(Vh, Vl, woh, wol, rows)


def df_update_sumsq_plain(Vh, Vl, wh, wl, u, rows: int):
    woh, wol = _update_plain(Vh, Vl, wh, wl, u, rows)
    return woh, wol, merge_f64(*df_sum(*df_mul(woh, wol, woh, wol)))


def _update_cuda(entry: str, Vh, Vl, wh, wl, u, rows: int):
    lib, m1, n, nb = _sweep_args(entry, Vh, Vl, rows, wh, wl, u)
    woh, wol = torch.empty_like(wh), torch.empty_like(wl)
    partials = torch.empty(nb, dtype=_f64, device=Vh.device)
    lib.call(f"gmres_{entry}", Vh.data_ptr(), Vl.data_ptr(), wh.data_ptr(), wl.data_ptr(),
             u.data_ptr(), woh.data_ptr(), wol.data_ptr(), partials.data_ptr(), n, rows, m1)
    return woh, wol, partials.sum(dim=0)


# K10's stages (csrc/df64_sweep.cu: kDfSmemBudget, kDfLine, kDfMaxTile,
# kDfBlocksPerSM): dynamic shared bytes of a block's two stages and u, in
# tiles of whole 128-byte lines, at most 8 KB a row; up to 2 blocks an SM
# where the stages are small
DF_SMEM_BUDGET = 230_400
DF_LINE = 32  # fp32 words in a 128-byte line
DF_MAX_TILE = 2048
DF_BLOCKS_PER_SM = 2
DF_STATIC_BYTES = 128  # the kernel's static shared memory, rounded up


@dataclasses.dataclass(frozen=True)
class DfUpdateGramPlan(GramPlan):
    """K10's launch geometry: GramPlan's tiles and persistent grid, and the
    dynamic shared bytes of a block (u's hi and lo words, each in whole
    16-byte chunks, and a ring of two stages, each the tile's ``rows`` rows
    of Vh and of Vl and w's pair)."""

    rows: int
    shared_bytes: int
    blocks_per_sm: int


def df_update_gram_plan(n: int, rows: int, sms: int, blocks_per_sm: int | None = None,
                        tile: int | None = None) -> DfUpdateGramPlan:
    """The widest tile of whole DF_LINE-word lines whose two stages, each
    2 x rows + 2 tile rows, and u fit DF_SMEM_BUDGET, capped at DF_MAX_TILE
    (or ``tile``, a whole number of lines no wider); as many blocks an SM as
    the stages leave room for, up to DF_BLOCKS_PER_SM (or
    ``blocks_per_sm``), no more than there are tiles."""
    u_words = 2 * (-(-rows // 4) * 4)
    fit = (DF_SMEM_BUDGET // 4 - u_words) // (2 * (2 * rows + 2)) // DF_LINE * DF_LINE
    widest = min(fit, DF_MAX_TILE)
    if tile is None:
        tile = widest
    elif tile % DF_LINE or not DF_LINE <= tile <= widest:
        raise ValueError(f"df_update_gram: tile {tile} is not a whole number of {DF_LINE}-word "
                         f"lines in {DF_LINE}..{widest}")
    shared = (2 * (2 * rows + 2) * tile + u_words) * 4
    per_sm = blocks_per_sm or min(
        DF_BLOCKS_PER_SM, SM_SHARED_BYTES // (shared + DF_STATIC_BYTES + BLOCK_RESERVED_BYTES))
    n_tiles = -(-n // tile)
    return DfUpdateGramPlan(n=n, tile=tile, n_tiles=n_tiles,
                            grid=max(1, min(n_tiles, sms * per_sm)), rows=rows,
                            shared_bytes=shared, blocks_per_sm=per_sm)


def df_update_gram_cuda(Vh, Vl, wh, wl, u, rows: int, blocks_per_sm: int | None = None,
                        tile: int | None = None):
    """K10: (w - u^T V, V (w - u^T V)) in one launch; ``blocks_per_sm`` and
    ``tile`` override the plan's (for timing).  The bits do not depend on
    the grid; u2's depend on the tile."""
    lib, m1, n, _ = _sweep_args("df_update_gram", Vh, Vl, rows, wh, wl, u)
    sms, ticket = _gram_state(Vh.device)
    plan = df_update_gram_plan(n, rows, sms, blocks_per_sm, tile)
    woh, wol = torch.empty_like(wh), torch.empty_like(wl)
    u2 = torch.empty(m1, dtype=_f64, device=Vh.device)
    partials = torch.empty(rows * plan.n_tiles, dtype=_f64, device=Vh.device)
    lib.call("gmres_df_update_gram", Vh.data_ptr(), Vl.data_ptr(), wh.data_ptr(), wl.data_ptr(),
             u.data_ptr(), woh.data_ptr(), wol.data_ptr(), u2.data_ptr(), partials.data_ptr(),
             ticket.data_ptr(), n, rows, m1, plan.tile, plan.n_tiles, plan.grid,
             plan.shared_bytes)
    df_update_gram_cuda.launches += 1
    df_update_gram_cuda.grid = plan.grid
    return woh, wol, u2


df_update_gram_cuda.launches = 0
df_update_gram_cuda.grid = 0


def df_update_sumsq_cuda(Vh, Vl, wh, wl, u, rows: int):
    """K11: (w - u^T V, ||w - u^T V||^2) in one sweep."""
    out = _update_cuda("df_update_sumsq", Vh, Vl, wh, wl, u, rows)
    df_update_sumsq_cuda.launches += 1
    return out


df_update_sumsq_cuda.launches = 0


def df_gram(Vh, Vl, wh, wl, rows: int):
    return (df_gram_cuda if Vh.is_cuda else df_gram_plain)(Vh, Vl, wh, wl, rows)


def df_update_gram(Vh, Vl, wh, wl, u, rows: int):
    return (df_update_gram_cuda if Vh.is_cuda else df_update_gram_plain)(Vh, Vl, wh, wl, u,
                                                                           rows)


def df_update_sumsq(Vh, Vl, wh, wl, u, rows: int):
    return (df_update_sumsq_cuda if Vh.is_cuda else df_update_sumsq_plain)(Vh, Vl, wh, wl, u,
                                                                             rows)
