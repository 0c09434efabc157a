"""Level-scheduled exact ILU(0) triangular solves for unstructured factors.

Carried from ``gmres_tpu.precond.level_ilu``, the analog of the
reference's level-scheduled cuSPARSE ``csrsv2`` (``kernels_cuda.cpp:617-695``)
for patterns that neither the banded K6 kernel nor plain full sweeps take:

  * host analysis: rows in ascending dependency-level order, grouped into
    chunks at level-aligned boundaries (``_level_chunks``);
  * apply: chunk by chunk, ``sweeps_c`` Jacobi sweeps over the chunk's rows
    alone (rows at the chunk's first level depend only on earlier chunks),
    so the work is ``sum_c sweeps_c * nnz_c`` instead of ``levels * nnz``.

The sweeps are a gather plus ``index_add_`` in the original row space (x is
never permuted), in plain torch: the JAX package runs this path on XLA
gathers, with no Pallas kernel.  Each chunk's sweep count is a host int, so
an apply never reads the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmres_tpu_torch.sparse import CSRMatrix
from gmres_tpu_torch.utils.profiling import span


def _level_chunks(lev: np.ndarray, rows_target: int) -> list[np.ndarray]:
    """Row indices grouped into chunks: ascending level order, whole levels
    accumulated up to ~rows_target rows, oversized levels split (rows of
    one level are independent)."""
    order = np.argsort(lev, kind="stable")
    bnd = np.flatnonzero(np.diff(lev[order])) + 1
    starts = np.concatenate([[0], bnd])
    ends = np.concatenate([bnd, [lev.shape[0]]])
    chunks: list[np.ndarray] = []
    cur: list[np.ndarray] = []
    cur_rows = 0
    for s, e in zip(starts, ends):
        size = e - s
        if size >= rows_target:
            if cur:
                chunks.append(np.concatenate(cur))
                cur, cur_rows = [], 0
            for p in range(s, e, rows_target):
                chunks.append(order[p:min(p + rows_target, e)])
            continue
        if cur_rows + size > rows_target and cur:
            chunks.append(np.concatenate(cur))
            cur, cur_rows = [], 0
        cur.append(order[s:e])
        cur_rows += size
    if cur:
        chunks.append(np.concatenate(cur))
    return chunks


def _ranges(rp: np.ndarray, rsel: np.ndarray) -> np.ndarray:
    """Concatenated arange(rp[r], rp[r+1]) over the rows rsel, without a
    Python loop: delta encoding and a cumsum."""
    cnt = (rp[rsel + 1] - rp[rsel]).astype(np.int64)
    tot = int(cnt.sum())
    if tot == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(tot, dtype=np.int64)
    starts_out = np.cumsum(cnt) - cnt
    nz = np.flatnonzero(cnt)
    first = rp[rsel[nz]].astype(np.int64)
    out[starts_out[nz[0]]] = first[0]
    if nz.size > 1:
        prev_last = first[:-1] + cnt[nz[:-1]] - 1
        out[starts_out[nz[1:]]] = first[1:] - prev_last
    return np.cumsum(out)


def _pack_phase(tri: CSRMatrix, lev: np.ndarray, rows_target: int, n: int):
    """A triangle's rows stacked into uniform [C, ...] chunk arrays (the
    values gathered in fp64, exactly, and returned as a tensor of the
    triangle's dtype, bf16 included).

    Returns (cols, vals, segs, rows, sweeps, rows_max, work): ``rows[c, k]
    == n`` marks a padding row (it writes x's pad slot), padding entries
    read the pad slot with value 0, and ``sweeps`` is a tuple of ints."""
    rp, ci = (a.numpy() for a in (tri.row_ptr, tri.col_idx))
    v = tri.vals.double().numpy()
    rp = rp.astype(np.int64)
    chunks = _level_chunks(lev, rows_target)
    rows_max = max(c.shape[0] for c in chunks)
    counts = np.diff(rp)
    nnz_max = max(max(int(counts[c].sum()) for c in chunks), 1)
    C = len(chunks)
    cols = np.full((C, nnz_max), n, dtype=np.int64)
    vals = np.zeros((C, nnz_max))
    segs = np.full((C, nnz_max), rows_max - 1, dtype=np.int64)
    rows = np.full((C, rows_max), n, dtype=np.int64)
    sweeps = []
    for c, rsel in enumerate(chunks):
        rows[c, :rsel.shape[0]] = rsel
        cnt = counts[rsel]
        tot = int(cnt.sum())
        if tot:
            idx = _ranges(rp, rsel)
            cols[c, :tot] = ci[idx]
            vals[c, :tot] = v[idx]
            segs[c, :tot] = np.repeat(np.arange(rsel.shape[0]), cnt)
        lv = lev[rsel]
        sweeps.append(int(lv.max() - lv.min()) + 1)
    return (cols, torch.from_numpy(vals).to(tri.vals.dtype), segs, rows, tuple(sweeps), rows_max,
            sum(sweeps) * nnz_max)


@dataclasses.dataclass(frozen=True)
class LevelILUPrec:
    """Exact ILU(0) solves by level-scheduled chunk sweeps (the csrsv2
    analog, ``kernels_cuda.cpp:617-695``)."""

    l_cols: torch.Tensor   # [C_l, NNZ_l] int64, padding -> the pad slot n
    l_vals: torch.Tensor   # [C_l, NNZ_l] factor dtype, padding 0
    l_segs: torch.Tensor   # [C_l, NNZ_l] int64 rank of the row in its chunk
    l_rows: torch.Tensor   # [C_l, R_l] int64 row ids, padding n
    l_sweeps: tuple        # sweeps per chunk (host ints)
    u_cols: torch.Tensor
    u_vals: torch.Tensor
    u_segs: torch.Tensor
    u_rows: torch.Tensor
    u_sweeps: tuple
    u_invd: torch.Tensor   # [C_u, R_u] inverse diagonal per chunk row (pad 1)
    inv_diag: torch.Tensor  # [n] (typesafe_apply reads its dtype)
    l_rows_max: int
    u_rows_max: int
    n: int

    def to(self, device) -> "LevelILUPrec":
        with span("precond.upload"):
            moved = {f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)}
            return dataclasses.replace(self, **moved)


def build_level_ilu(lower: CSRMatrix, upper: CSRMatrix, inv_diag,
                    lev_l: np.ndarray, lev_u: np.ndarray, rows_target: int = 65536):
    """Pack the split triangles (strict lower, upper with the diagonal)
    into a LevelILUPrec (``inv_diag`` a tensor, or a numpy array of an
    fp32 or fp64 M).  Returns (prec, work), work bounding the gathers of
    one apply."""
    n = lower.n_rows
    lc, lv, ls, lr, lsw, lrm, wl = _pack_phase(lower, lev_l, rows_target, n)
    uc, uv, us, ur, usw, urm, wu = _pack_phase(upper, lev_u, rows_target, n)
    inv_diag = torch.as_tensor(inv_diag)
    u_invd = torch.ones(ur.shape, dtype=inv_diag.dtype)
    valid = ur != n
    u_invd[torch.from_numpy(valid)] = inv_diag[torch.from_numpy(ur[valid])]
    t = torch.from_numpy
    prec = LevelILUPrec(l_cols=t(lc), l_vals=lv, l_segs=t(ls), l_rows=t(lr),
                        l_sweeps=lsw, u_cols=t(uc), u_vals=uv, u_segs=t(us),
                        u_rows=t(ur), u_sweeps=usw, u_invd=u_invd, inv_diag=inv_diag,
                        l_rows_max=lrm, u_rows_max=urm, n=n)
    return prec, wl + wu


def level_ilu_apply(M: LevelILUPrec, w: torch.Tensor) -> torch.Tensor:
    """(LU)^-1 w by level-scheduled chunk sweeps:

        L phase (unit diagonal):  chunk rows x_r <- b_r - (L_s x)_r
        U phase:                  chunk rows x_r <- x_r + D_r^-1 (b'_r - (U x)_r)

    the recurrences of the ILU-Jacobi apply, one chunk at a time, each sweep
    double-buffered within its chunk."""
    x = torch.cat([w, w.new_zeros(1)])  # slot n: the padding rows' target, 0
    b = x.clone()
    for c, sweeps in enumerate(M.l_sweeps):
        cols, vals, segs, rows = M.l_cols[c], M.l_vals[c], M.l_segs[c], M.l_rows[c]
        b_rows = b[rows]
        for _ in range(sweeps):
            contrib = x.new_zeros(M.l_rows_max).index_add_(0, segs, vals * x[cols])
            x[rows] = b_rows - contrib
    x[M.n] = 0
    b2 = x.clone()
    for c, sweeps in enumerate(M.u_sweeps):
        cols, vals, segs, rows = M.u_cols[c], M.u_vals[c], M.u_segs[c], M.u_rows[c]
        b_rows, invd = b2[rows], M.u_invd[c]
        for _ in range(sweeps):
            contrib = x.new_zeros(M.u_rows_max).index_add_(0, segs, vals * x[cols])
            x[rows] = x[rows] + invd * (b_rows - contrib)
    return x[: M.n]
