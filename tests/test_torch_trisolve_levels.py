"""The redesigned K2 and K6 on the CPU: K6's level schedule and its
level-ordered twin, and K2's tile and grid plan.

- The schedule (``trisolve_kernel.level_schedule``), built from the DIA
  bands, on convdiff(7/16/32/60), random banded nonsymmetric factors with up
  to 64 bands, one-sided factors and a converted JAX state with lane padding
  and identity tail segments: each triangle's rows are a permutation, every
  dependency of a row lies at a lower level, the level counts equal
  ``steps_l``/``steps_u`` (per segment ``steps_*_segs``) and the levels
  those of ``triangular_levels`` on the CSR pattern; the neighbour
  positions (none for a stored zero band), U positions and repacked bands
  are the arrays the kernel reads.  A preconditioner gets its schedule
  when it moves to the card, not on the CPU.  ``level_grid`` picks one
  block while the widest level fits it, else a grid; the fused wrapper
  refuses a ``sync=`` that is neither before anything is built.
- ``ilu_trisolve_levels_plain``, the kernel's data path in torch, equals the
  plain sweeps (``ilu_trisolve_fused_plain``, ``ilu_trisolve_segmented_plain``)
  bit for bit in fp32 and fp64, and is held to the JAX package's
  ``ilu_trisolve_fused``/``ilu_trisolve_segmented`` (interpret mode) within
  1e-6 of the largest value in fp32, as ``tests/test_torch_ilu.py`` holds the
  sweeps (the two sum in other orders).
- K2's plan covers every column exactly once for many n, and its split of a
  row's tile at each 16-byte phase covers the tile exactly once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gmres_tpu.native as jax_native
from gmres_tpu.io import synth as jax_synth
from gmres_tpu.ops.pallas.trisolve_kernel import ilu_trisolve_fused as jax_fused
from gmres_tpu.ops.pallas.trisolve_kernel import ilu_trisolve_segmented as jax_segmented
from gmres_tpu.precond import build as jax_build
from gmres_tpu.solver.gmres import _pad_prec
from gmres_tpu_torch import convert
from gmres_tpu_torch.io.synth import convection_diffusion_2d
from gmres_tpu_torch.ops.cuda import orth_kernel as ok
from gmres_tpu_torch.ops.cuda import trisolve_kernel as tk
from gmres_tpu_torch.precond import build as port_build
from gmres_tpu_torch.precond.ilu0 import diag_positions, triangular_levels

from test_torch_solver import _port_csr

DTYPES = pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["f32", "f64"])


@pytest.fixture(autouse=True)
def jax_ilu_on_numpy(monkeypatch):
    if jax_native._lib is None:
        monkeypatch.setattr(jax_native, "_lib_failed", True)


def _levels_of(S, tag):
    """Per-row level from a schedule triangle's rows and pointers."""
    rows, ptr = getattr(S, f"rows_{tag}").numpy(), getattr(S, f"ptr_{tag}").numpy()
    lev = np.empty(rows.shape[0], dtype=np.int64)
    for k in range(ptr.shape[0] - 1):
        lev[rows[ptr[k]:ptr[k + 1]]] = k
    return lev


def _check_schedule(S, ld, ud, invd, offs_l, offs_u):
    """The schedule's invariants against the bands it was built from;
    returns the per-row levels (L, U)."""
    width = invd.shape[0]
    levs = []
    for tag, bands, offs in (("l", ld, offs_l), ("u", ud, offs_u)):
        rows = getattr(S, f"rows_{tag}").numpy()
        ptr = getattr(S, f"ptr_{tag}").numpy()
        assert np.array_equal(np.sort(rows), np.arange(width))
        assert ptr[0] == 0 and ptr[-1] == width and np.all(np.diff(ptr) > 0)
        assert ptr.shape[0] - 1 == getattr(S, f"nlev_{tag}")
        assert getattr(S, f"width_{tag}") == np.diff(ptr).max()
        lev = _levels_of(S, tag)
        pos = np.empty(width, dtype=np.int64)
        pos[rows] = np.arange(width)
        b = bands.numpy()[: len(offs)]
        dep = getattr(S, f"dep_{tag}").numpy()
        assert np.array_equal(getattr(S, f"bands_{tag}").numpy(), b[:, rows])
        for d, off in enumerate(offs):
            i = np.arange(width)
            j = i + off
            live = (j >= 0) & (j < width)
            nz = live & (b[d] != 0)
            assert np.all(lev[j[nz]] < lev[i[nz]])  # every dependency lower
            # a stored zero band is no neighbour, as a column outside the width
            want = np.where(nz[rows], pos[np.clip(j[rows], 0, width - 1)], -1)
            assert np.array_equal(dep[d], want)
        levs.append(lev)
    assert np.array_equal(S.rows_u.numpy()[S.upos_l.numpy()], S.rows_l.numpy())
    assert np.array_equal(S.invd_u.numpy(), invd.numpy()[S.rows_u.numpy()])
    return levs


@pytest.mark.parametrize("nx", [7, 16, 32, 60])
def test_schedule_of_the_port_build(nx):
    A = convection_diffusion_2d(nx, beta=2.0)
    M = port_build.build_ilu_exact(A, torch.float64)
    S = M.with_schedule().schedule
    lev_l, lev_u = _check_schedule(S, M.lower_bands, M.upper_bands, M.inv_diag, M.offs_l,
                                   M.offs_u)
    assert (S.nlev_l, S.nlev_u) == (M.steps_l, M.steps_u) == (2 * nx - 1, 2 * nx - 1)
    assert S.width_l == S.width_u == nx  # the anti-diagonals
    rp, ci, _ = A.numpy_arrays()
    want_l, want_u = triangular_levels(rp, ci, diag_positions(rp, ci))
    assert np.array_equal(lev_l, want_l) and np.array_equal(lev_u, want_u)


def _random_bands(n, d, seed, dt=torch.float64):
    """Random strictly-lower and strictly-upper bands (d each, offsets in no
    particular order, about half the stored values zero) and an inverse
    diagonal."""
    rng = np.random.default_rng(seed)
    offs_l = tuple(int(o) for o in -rng.choice(np.arange(1, n), size=d, replace=False))
    offs_u = tuple(int(o) for o in rng.choice(np.arange(1, n), size=d, replace=False))
    ld, ud = (torch.tensor(0.3 / d * rng.standard_normal((d, n)) * (rng.random((d, n)) < 0.5),
                           dtype=dt) for _ in range(2))
    invd = torch.tensor(1.0 / (2.0 + rng.random(n)), dtype=dt)
    return ld, ud, invd, offs_l, offs_u


def _band_csr_levels(ld, ud, offs_l, offs_u, n):
    """triangular_levels of the CSR pattern the bands' nonzeros make (a
    unit diagonal stored in every row)."""
    rows, cols = [np.arange(n)], [np.arange(n)]
    for bands, offs in ((ld, offs_l), (ud, offs_u)):
        b = bands.numpy()
        for d, off in enumerate(offs):
            i = np.flatnonzero(b[d] != 0)
            i = i[(i + off >= 0) & (i + off < n)]
            rows.append(i)
            cols.append(i + off)
    r, c = np.concatenate(rows), np.concatenate(cols)
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    rp = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=n))])
    return triangular_levels(rp, c, diag_positions(rp, c))


@pytest.mark.parametrize("n,d,seed", [(200, 1, 0), (300, 5, 1), (500, 17, 2), (700, 64, 3)])
def test_schedule_of_random_bands(n, d, seed):
    ld, ud, invd, offs_l, offs_u = _random_bands(n, d, seed)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    lev_l, lev_u = _check_schedule(S, ld, ud, invd, offs_l, offs_u)
    want_l, want_u = _band_csr_levels(ld, ud, offs_l, offs_u, n)
    assert np.array_equal(lev_l, want_l) and np.array_equal(lev_u, want_u)
    assert (S.nlev_l, S.nlev_u) == (want_l.max() + 1, want_u.max() + 1)


@pytest.mark.parametrize("n,d,seg", [(300, 5, 64), (700, 17, 128), (700, 64, 700)])
def test_segment_levels_of_random_bands(n, d, seg):
    # a segment's own level count is that of its rows' bands cut out alone
    # (dependencies outside the segment dropped); the global levels stay
    ld, ud, invd, offs_l, offs_u = _random_bands(n, d, n + seg)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u, seg)
    want = [tk.level_schedule(ld[:, a:a + seg], ud[:, a:a + seg], invd[a:a + seg], offs_l,
                              offs_u) for a in range(0, n, seg)]
    assert S.seg_levels_l == tuple(c.nlev_l for c in want)
    assert S.seg_levels_u == tuple(c.nlev_u for c in want)
    S0 = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    assert (S.nlev_l, S.nlev_u) == (S0.nlev_l, S0.nlev_u)
    assert torch.equal(S.rows_l, S0.rows_l) and torch.equal(S.dep_u, S0.dep_u)


@pytest.mark.parametrize("upper", [True, False], ids=["upper_only", "lower_only"])
def test_schedule_of_one_sided_factors(upper):
    n = 300
    ld, ud, invd, offs_l, offs_u = _random_bands(n, 3, 7)
    empty = torch.zeros((0, n), dtype=torch.float64)
    ld, offs_l = (empty, ()) if upper else (ld, offs_l)
    ud, offs_u = (ud, offs_u) if upper else (empty, ())
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    _check_schedule(S, ld, ud, invd, offs_l, offs_u)
    assert (S.nlev_l == 1) == upper and (S.nlev_u == 1) != upper
    assert tk.level_grid(max(S.width_l if offs_l else 0, S.width_u))[0] == "block"
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(n))
    want = tk.ilu_trisolve_fused_plain(ld, ud, invd, w, offs_l, offs_u, S.nlev_l, S.nlev_u)
    assert torch.equal(tk.ilu_trisolve_levels_plain(S, w), want)


def test_schedule_refuses_offsets_on_the_wrong_side():
    ld, ud, invd, offs_l, offs_u = _random_bands(100, 2, 9)
    with pytest.raises(ValueError, match="side of the diagonal"):
        tk.level_schedule(ld, ud, invd, tuple(-o for o in offs_l), offs_u)


def _jax_state(nx, budget, monkeypatch):
    A = jax_synth.convection_diffusion_2d(nx, beta=2.0)
    if budget is not None:
        monkeypatch.setattr(jax_build, "_TRISOLVE_VMEM_BYTES", budget)
    Mj = jax_build.build_ilu_exact(A, np.float32)
    assert isinstance(Mj, jax_build.ExactILUDIAPrec)
    return A, Mj


def _converted(Mj):
    return convert.exact_ilu_from_numpy(
        np.asarray(Mj.lower_bands), np.asarray(Mj.upper_bands), np.asarray(Mj.inv_diag),
        Mj.offs_l, Mj.offs_u, Mj.steps_l, Mj.steps_u, Mj.seg, Mj.steps_l_segs,
        Mj.steps_u_segs)


@pytest.mark.parametrize("pad", [False, True], ids=["lane_padded", "identity_tail_segments"])
def test_schedule_of_a_converted_jax_state(pad, monkeypatch):
    # the JAX state's bands are lane-padded past n (zero bands, inverse
    # diagonal 1); padded to a whole number of segments they gain identity
    # tail segments (solver/gmres.py:_pad_prec)
    A, Mj = _jax_state(60, 60_000, monkeypatch)
    if pad:
        Mj = _pad_prec(Mj, 3 * Mj.seg + 5)
    M = _converted(Mj)
    assert M.schedule is None  # converted onto the CPU: no kernel to run it
    S = M.with_schedule().schedule
    width = M.inv_diag.shape[0]
    assert width > A.n_rows
    lev_l, lev_u = _check_schedule(S, M.lower_bands, M.upper_bands, M.inv_diag, M.offs_l,
                                   M.offs_u)
    assert (S.nlev_l, S.nlev_u) == (Mj.steps_l, Mj.steps_u)
    assert S.seg == Mj.seg > 0
    assert (S.seg_levels_l, S.seg_levels_u) == (tuple(Mj.steps_l_segs),
                                                tuple(Mj.steps_u_segs))
    rp = np.asarray(A.row_ptr).astype(np.int64)
    ci = np.asarray(A.col_idx)[: rp[-1]]
    want_l, want_u = triangular_levels(rp, ci, diag_positions(rp, ci))
    n = A.n_rows
    assert np.array_equal(lev_l[:n], want_l) and np.array_equal(lev_u[:n], want_u)
    assert not lev_l[n:].any() and not lev_u[n:].any()  # padded rows depend on nothing
    w = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    want = np.asarray(jax_segmented(Mj.lower_bands, Mj.upper_bands, Mj.inv_diag,
                                    jnp.asarray(w), Mj.offs_l, Mj.offs_u, Mj.steps_l_segs,
                                    Mj.steps_u_segs, Mj.seg))
    got = tk.ilu_trisolve_levels_plain(S, torch.from_numpy(w))
    assert got.shape == (n,)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    args = (M.lower_bands, M.upper_bands, M.inv_diag, torch.from_numpy(w), M.offs_l, M.offs_u)
    assert torch.equal(got, tk.ilu_trisolve_segmented_plain(*args, M.steps_l_segs,
                                                            M.steps_u_segs, M.seg))


@DTYPES
@pytest.mark.parametrize("nx", [7, 16, 32])
def test_levels_twin_bit_equal_to_sweeps_and_close_to_jax(dt, nx, monkeypatch):
    # fused and segmented sweeps, the level-ordered twin: one set of bits
    A = convection_diffusion_2d(nx, beta=2.0)
    M = port_build.build_ilu_exact(A, dt)
    w = torch.tensor(np.random.default_rng(nx).standard_normal(nx * nx), dtype=dt)
    args = (M.lower_bands, M.upper_bands, M.inv_diag, w, M.offs_l, M.offs_u)
    got = tk.ilu_trisolve_levels_plain(M.with_schedule().schedule, w)
    assert torch.equal(got, tk.ilu_trisolve_fused_plain(*args, M.steps_l, M.steps_u))
    monkeypatch.setattr(port_build, "_TRISOLVE_L2_BYTES", 9 * dt.itemsize * nx * nx // 2)
    Ms = port_build.build_ilu_exact(A, dt)
    if nx * nx > 1024:  # segments are whole multiples of 1024 rows
        assert Ms.seg == 1024 and len(Ms.steps_l_segs) > 1
        assert torch.equal(got, tk.ilu_trisolve_segmented_plain(
            *args, Ms.steps_l_segs, Ms.steps_u_segs, Ms.seg))
        Ss = Ms.with_schedule().schedule
        assert (Ss.seg_levels_l, Ss.seg_levels_u) == (Ms.steps_l_segs, Ms.steps_u_segs)
        assert torch.equal(tk.ilu_trisolve_levels_plain(Ss, w), got)
    if dt == torch.float32:  # the TPU kernel is fp32 only
        Mj = jax_build.build_ilu_exact(jax_synth.convection_diffusion_2d(nx, beta=2.0),
                                       np.float32)
        want = np.asarray(jax_fused(Mj.lower_bands, Mj.upper_bands, Mj.inv_diag,
                                    jnp.asarray(w.numpy()), Mj.offs_l, Mj.offs_u, Mj.steps_l,
                                    Mj.steps_u))
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@DTYPES
@pytest.mark.parametrize("n,d", [(300, 3), (500, 17), (700, 64)])
def test_levels_twin_bit_equal_on_random_bands(dt, n, d):
    ld, ud, invd, offs_l, offs_u = _random_bands(n, d, n + d, dt)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    w = torch.tensor(np.random.default_rng(d).standard_normal(n), dtype=dt)
    want = tk.ilu_trisolve_fused_plain(ld, ud, invd, w, offs_l, offs_u, S.nlev_l, S.nlev_u)
    assert torch.equal(tk.ilu_trisolve_levels_plain(S, w), want)


def test_schedule_rides_on_the_preconditioner():
    # none for a CPU solve; built once (.to a CUDA device calls
    # with_schedule), kept by later moves, passed to K6
    M = port_build.build_ilu_exact(convection_diffusion_2d(12, beta=2.0), torch.float32)
    assert M.schedule is None and M.to("cpu").schedule is None
    Ms = M.with_schedule()
    assert isinstance(Ms.schedule, tk.LevelSchedule) and Ms.with_schedule() is Ms
    moved = Ms.to("cpu")
    assert moved.schedule.rows_l.dtype == torch.int32
    assert torch.equal(moved.schedule.bands_u, Ms.schedule.bands_u)


def test_level_grid_follows_the_widest_level():
    assert tk.level_grid(1) == tk.level_grid(1024) == ("block", 1)
    assert tk.level_grid(1025) == ("grid", 2)
    assert tk.level_grid(8 * 1024) == ("grid", 8)
    assert tk.level_grid(8 * 1024 + 1) == ("grid", 9)


def _blocked_levels(widest, dt=torch.float64):
    """Factors whose levels are blocks of ``widest`` rows: L offsets
    (-widest, -widest - 1), U offsets (widest, widest + 1), every stored
    value nonzero, 3 * widest + (widest + 1) // 2 rows (four levels a
    triangle, the last one short but where widest is 1)."""
    n = 3 * widest + (widest + 1) // 2
    rng = np.random.default_rng(widest)
    ld, ud = (torch.tensor(0.2 * rng.standard_normal((2, n)) + 0.3, dtype=dt) for _ in range(2))
    invd = torch.tensor(1.0 / (2.0 + rng.random(n)), dtype=dt)
    return ld, ud, invd, (-widest, -widest - 1), (widest, widest + 1)


@pytest.mark.parametrize("widest,form", [
    (1, ("block", 1)), (100, ("block", 1)), (1024, ("block", 1)), (1025, ("grid", 2)),
    (2048, ("grid", 2)), (8193, ("grid", 9))])
def test_level_grid_of_a_schedule(widest, form):
    # one block while the widest level fits its 1024 threads, else a grid of
    # a block per 1024 rows of it; the twin keeps the sweeps' bits at each
    ld, ud, invd, offs_l, offs_u = _blocked_levels(widest)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    assert (S.width_l, S.width_u, S.nlev_l, S.nlev_u) == (widest, widest, 4, 4)
    assert tk.level_grid(max(S.width_l, S.width_u)) == form
    w = torch.from_numpy(np.random.default_rng(widest + 1).standard_normal(invd.shape[0]))
    want = tk.ilu_trisolve_fused_plain(ld, ud, invd, w, offs_l, offs_u, 4, 4)
    assert torch.equal(tk.ilu_trisolve_levels_plain(S, w), want)


@pytest.mark.parametrize("sync", [("cluster", 2), ("block", 2), ("grid", 0), ("warp", 1)])
def test_fused_wrapper_refuses_a_bad_sync(sync):
    # refused before a tensor is looked at or anything is built
    ld, ud, invd, offs_l, offs_u = _blocked_levels(4)
    S = tk.level_schedule(ld, ud, invd, offs_l, offs_u)
    with pytest.raises(ValueError, match="sync"):
        tk.ilu_trisolve_fused_cuda(ld, ud, invd, invd, offs_l, offs_u, 4, 4, schedule=S,
                                   sync=sync)


def test_a_stored_zero_band_is_no_neighbour():
    # convdiff's L band at offset -1 stores a zero in each grid row's first
    # column, pointing at the previous grid row's last column (a later
    # level): the schedule gives it no neighbour.  With every value finite
    # the twin keeps the sweeps' bits; an inf there reaches in the twin only
    # the rows that depend on it, and in the sweeps (0 x inf) each row after
    nx = 16
    M = port_build.build_ilu_exact(convection_diffusion_2d(nx, beta=2.0), torch.float64)
    d = M.offs_l.index(-1)
    first = np.arange(1, nx) * nx
    assert np.all(M.lower_bands[d, first].numpy() == 0)
    empty = torch.zeros((0, nx * nx), dtype=torch.float64)
    ones = torch.ones(nx * nx, dtype=torch.float64)
    S = tk.level_schedule(M.lower_bands, empty, ones, M.offs_l, ())
    assert np.all(S.dep_l[d, S.rows_l.argsort()[first]].numpy() == -1)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal(nx * nx))
    args = (M.lower_bands, empty, ones, w, M.offs_l, (), S.nlev_l, 1)
    assert torch.equal(tk.ilu_trisolve_levels_plain(S, w), tk.ilu_trisolve_fused_plain(*args))
    w[nx - 1] = float("inf")
    got = tk.ilu_trisolve_levels_plain(S, w).view(nx, nx)
    sweeps = tk.ilu_trisolve_fused_plain(*args).view(nx, nx)
    assert torch.isfinite(got[:, :-1]).all() and not torch.isfinite(got[:, -1]).any()
    assert torch.isnan(sweeps[1:]).all()
    assert torch.equal(got[0], sweeps[0])


@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 2048, 70_001, 2 ** 20 + 3])
@pytest.mark.parametrize("itemsize", [4, 8, 2])
def test_gram_plan_covers_every_column_once(n, itemsize):
    for sms, per_sm in ((132, 4), (132, 1), (7, 3)):
        plan = ok.gram_plan(n, itemsize, sms, per_sm)
        assert 1 <= plan.grid <= min(plan.n_tiles, sms * per_sm)
        seen = np.zeros(n, dtype=np.int64)
        for b in range(plan.grid):
            for t in plan.tiles_of(b):
                cols = plan.columns(t)
                seen[cols.start:cols.stop] += 1
        assert np.all(seen == 1)


@pytest.mark.parametrize("vec", [2, 4, 8])
def test_gram_row_split_covers_the_tile_once(vec):
    # every phase of a row's first aligned column, full and ragged tiles;
    # vector loads start on the phase's aligned columns
    for cols in (1, 3, vec, 1000, ok.GRAM_TILE - 1, ok.GRAM_TILE):
        for phase in range(vec):
            vector, scalar = ok.tile_row_split(cols, phase, vec)
            covered = [c for v in vector for c in range(v, v + vec)] + scalar
            assert sorted(covered) == list(range(cols))
            assert all((v - phase) % vec == 0 and v + vec <= cols for v in vector)
            assert len(scalar) < 2 * vec
