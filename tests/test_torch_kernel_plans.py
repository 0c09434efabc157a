"""The launch geometry of the redesigned K3 GRAM and K7, on the CPU (no
kernel runs here; the card tests hold the kernels themselves).

- ``update_gram_plan`` (K3 GRAM in fp32 and its dtype forms,
  ``csrc/basis_sweep.cu``): its tiles cover every column exactly once over
  the persistent grid, its tile is a whole number of 128-byte lines of a
  basis row, and its two stages (each the tile's rows and w's tile, each
  row in its own dtype), u and a bf16 w's unrounded w' fit the per-block
  budget, for every rows in 1..256; where n is a multiple of the basis's
  vector width every staged row of every tile is whole 16-byte chunks (the
  bulk copies' sizes).
- ``mgs_groups`` (K7, ``csrc/basis_mgs.cu``): a row's partials are those
  of fixed groups of tiles that depend on n only; the groups cover every
  column once, and every register tiling and grid-stride grid the kernel
  may take hands each group to exactly one block, so h has the same bits
  on every grid; the tags of its slots are new at every launch.
- ``dia_plan`` (K1, ``csrc/dia_spmv.cu``): every row lies in one block of
  rows, and a launch of any grid sweeps every block once; a block is
  interior exactly when none of its rows reads x outside [0, n_cols) for
  any band, so the window path takes every row that does; the plan is the
  same for every lane count, and s <= 8 lanes are one launch.
- ``halo_plan`` (K12, K1's kernel with the halo edges): every row of the
  shard lies in one block, each block interior or on the window path; an
  interior row reads only x for every band, and a block takes the window
  path only when one of its rows reads past x.
- ``df_update_gram_plan`` (K10, ``csrc/df64_sweep.cu``): its two stages
  (each the tile's rows of Vh and Vl and w's pair) and u fit the per-block
  budget for every rows in 1..256, and its tiles cover every column exactly
  once over the persistent grid.
- K2x2 (``basis_gram_kernel`` with two vectors, ``csrc/basis_sweep.cu``)
  runs K2's plan: K2's tiles on a grid of its own blocks an SM.
- ``axpy_plan`` (K4, ``csrc/basis_sweep.cu``): thread chunks of 16 bytes
  of a basis row cover every column exactly once on either grid shape
  (persistent, one block a tile); and a model of how the kernel reads a
  basis row (16-byte loads where the row's chunk starts aligned and is
  whole, else value by value) covers every column of the row once, for
  every form and every phase of V's and x's first value, whole chunks only
  in the aligned form.
"""

import numpy as np
import pytest
import torch

from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
from gmres_tpu_torch.ops.cuda import halo_kernel as hk
from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
from gmres_tpu_torch.ops.cuda import orth_kernel as ok
from gmres_tpu_torch.ops.cuda import outer_kernel as ou
from gmres_tpu_torch.ops.cuda import spmv_kernel as sk
from gmres_tpu_torch.ops.cuda._build import AXPY_FORMS


def test_update_gram_two_stages_fit_for_every_height(itemsize=4):
    for rows in range(1, 257):
        plan = ok.update_gram_plan(1 << 20, rows, itemsize, 132)
        assert plan.tile >= ok.UG_LINE // itemsize and plan.tile % (ok.UG_LINE // itemsize) == 0
        assert plan.tile * itemsize <= ok.UG_MAX_ROW_BYTES
        assert plan.shared_bytes == (2 * (rows + 1) * plan.tile + -(-rows // (16 // itemsize))
                                     * (16 // itemsize)) * itemsize
        assert plan.shared_bytes <= ok.UG_SMEM_BUDGET
        per_block = plan.shared_bytes + ok.UG_STATIC_BYTES + ok.BLOCK_RESERVED_BYTES
        assert per_block <= 232_448  # a block's 227 KB
        assert 1 <= plan.blocks_per_sm <= ok.UG_BLOCKS_PER_SM
        assert plan.blocks_per_sm * per_block <= ok.SM_SHARED_BYTES
        assert plan.stride >= plan.n_tiles and plan.stride % (16 // itemsize) == 0


@pytest.mark.parametrize("n", [1, 3, 447, 1025, 70_001, 2 ** 20, 2 ** 20 + 3])
@pytest.mark.parametrize("rows", [1, 7, 31, 256])
def test_update_gram_plan_covers_every_column_once(n, rows, itemsize=4):
    for sms, per_sm in ((132, None), (132, 1), (7, 3)):
        plan = ok.update_gram_plan(n, rows, itemsize, sms, per_sm)
        assert 1 <= plan.grid <= min(plan.n_tiles, sms * plan.blocks_per_sm)
        seen = np.zeros(n, dtype=np.int64)
        for b in range(plan.grid):
            for t in plan.tiles_of(b):
                cols = plan.columns(t)
                seen[cols.start:cols.stop] += 1
        assert np.all(seen == 1)


# the dtype forms of the compressed-basis and bf16 tiers: (basis, w) item sizes
FORMS = pytest.mark.parametrize("itemsize,w_itemsize", [(2, 4), (4, 8), (2, 2)],
                                ids=["bf16_f32", "f32_f64", "bf16_bf16"])


@FORMS
def test_update_gram_forms_fit_for_every_height(itemsize, w_itemsize):
    # the stages hold the basis rows in their dtype and w's row in its own,
    # u in the accumulation dtype, and a bf16 w's unrounded w' in fp32 beside
    # them; every staged row starts on a 16-byte boundary
    acc = 8 if w_itemsize == 8 else 4
    for rows in range(1, 257):
        plan = ok.update_gram_plan(1 << 20, rows, itemsize, 132, w_itemsize=w_itemsize)
        line = ok.UG_LINE // itemsize
        assert plan.tile >= line and plan.tile % line == 0
        assert plan.tile * itemsize <= ok.UG_MAX_ROW_BYTES
        assert plan.tile * w_itemsize % 16 == 0 and plan.tile * acc % 16 == 0
        u_bytes = -(-rows // (16 // acc)) * 16
        wp = plan.tile * acc if w_itemsize != acc else 0
        assert plan.shared_bytes == u_bytes + wp + 2 * plan.tile * (rows * itemsize + w_itemsize)
        assert plan.shared_bytes <= ok.UG_SMEM_BUDGET
        per_block = plan.shared_bytes + ok.UG_STATIC_BYTES + ok.BLOCK_RESERVED_BYTES
        assert per_block <= 232_448
        assert 1 <= plan.blocks_per_sm <= ok.UG_BLOCKS_PER_SM
        assert plan.blocks_per_sm * per_block <= ok.SM_SHARED_BYTES
        assert plan.stride >= plan.n_tiles and plan.stride % (16 // acc) == 0
        # the fp32 form's plan is the one-item-size plan
        assert ok.update_gram_plan(1 << 20, rows, 4, 132, w_itemsize=4) == \
            ok.update_gram_plan(1 << 20, rows, 4, 132)


@FORMS
@pytest.mark.parametrize("n", [1, 3, 447, 1025, 70_001, 70_008, 2 ** 20, 2 ** 20 + 3])
@pytest.mark.parametrize("rows", [1, 31, 256])
def test_update_gram_forms_cover_every_column_once(itemsize, w_itemsize, n, rows):
    # n not a multiple of 8 included; where it is a multiple of the basis's
    # vector width (the aligned form's bulk copies), every tile, the last
    # too, copies whole 16-byte chunks of each staged row
    for sms, per_sm in ((132, None), (7, 3)):
        plan = ok.update_gram_plan(n, rows, itemsize, sms, per_sm, w_itemsize)
        seen = np.zeros(n, dtype=np.int64)
        for b in range(plan.grid):
            for t in plan.tiles_of(b):
                cols = plan.columns(t)
                seen[cols.start:cols.stop] += 1
                if n % (16 // itemsize) == 0:
                    assert len(cols) * itemsize % 16 == 0 and len(cols) * w_itemsize % 16 == 0
        assert np.all(seen == 1)


@pytest.mark.parametrize("n", [1, 1023, 1025, 70_001, 262_145, 300_001, 2 ** 20, 4 * 2 ** 20 + 7])
def test_mgs_groups_cover_every_tile_once_on_every_grid(n):
    # K7's row partials are those of fixed groups of tiles (a power of two,
    # at most 8 tiles, at most MGS_SLOTS groups unless 8 tiles leave more);
    # every register tiling of whole groups and the L2 form's grid-stride
    # walk give each group, and so each column, to exactly one block
    tile = 1024
    n_tiles = -(-n // tile)
    group, n_groups = mk.mgs_groups(n, tile)
    assert group in (1, 2, 4, 8) and n_groups == -(-n_tiles // group)
    assert n_groups <= mk.MGS_SLOTS or group == mk.MAX_REGISTER_TILES
    assert group == 1 or -(-n_tiles // (group // 2)) > mk.MGS_SLOTS
    cols = np.zeros(n, dtype=np.int64)
    for g in range(n_groups):
        r = mk.group_columns(n, g, group, tile)
        cols[r.start:r.stop] += 1
    assert np.all(cols == 1)
    for tiles in (t for t in (1, 2, 4, 8) if t >= group):
        blocks = -(-n_tiles // tiles)
        owner = np.repeat(np.arange(blocks), tiles // group)[:n_groups]
        assert owner.size == n_groups and np.all(np.diff(owner) >= 0)
    for grid in (1, 7, 132, n_groups):
        seen = np.zeros(n_groups, dtype=np.int64)
        for b in range(min(grid, n_groups)):
            seen[b::grid] += 1
        assert np.all(seen == 1)


def test_mgs_slot_tags_are_new_at_every_launch(monkeypatch):
    # a launch's tags (epoch * 256 + row) were never written to the words
    # before: the epoch rises a launch, and the words are zeroed when the
    # epochs run out or made anew (zeroed) when they grow
    monkeypatch.setattr(mk, "_EPOCHS", 4)
    slots, cpu = mk._Slots(), torch.device("cpu")
    words, tag = slots.take(cpu, 10)
    assert tag == 1 << 8 and not words.any()
    words.fill_(7)
    for epoch in (2, 3):
        again, tag = slots.take(cpu, 10)
        assert tag == epoch << 8 and again is words and words.eq(7).all()
    words, tag = slots.take(cpu, 10)
    assert tag == 1 << 8 and not words.any()
    grown, tag = slots.take(cpu, 20)
    assert tag == 1 << 8 and grown.numel() == 20 and not grown.any()


CONVDIFF_1M = (-1024, -1, 0, 1, 1024)
# K1's band sets: convdiff@1M's, its ILU factors' (strict L, L with the
# diagonal: offsets <= 0; U) and a random set of 9 bands
K1_OFFSETS = {
    "convdiff": CONVDIFF_1M,
    "ilu-L": (-1024, -1),
    "ilu-L-diag": (-1024, -1, 0),
    "ilu-U": (0, 1, 1024),
    "random": tuple(sorted(np.random.default_rng(16).choice(np.arange(-3000, 3001), 9,
                                                            replace=False).tolist())),
}
K1_ROWS = (1, 7, 8, 9, 1023, 1025, 4099, 262_144, 1_048_576)


def _check_dia_plan(plan, offsets, n, n_cols, itemsize, rows=None):
    assert plan.block_rows == 256 * (rows or 16 // itemsize)
    assert plan.n_blocks == -(-n // plan.block_rows)
    assert 0 <= plan.b0 <= plan.b1 <= plan.n_blocks
    b = np.arange(plan.n_blocks)
    starts = b * plan.block_rows
    stops = np.minimum(starts + plan.block_rows, n)
    # the blocks tile the rows: each row in exactly one block
    assert starts[0] == 0 and stops[-1] == n and np.all(stops > starts)
    assert np.all(starts[1:] == stops[:-1])
    assert [len(plan.rows(k)) for k in (0, plan.n_blocks - 1)] == [stops[0], n - starts[-1]]
    # interior exactly when no row of the block reads x outside [0, n_cols)
    reads_past = (starts + min(offsets) < 0) | (stops - 1 + max(offsets) >= n_cols)
    interior = np.array([plan.interior(k) for k in b])
    np.testing.assert_array_equal(interior, ~reads_past)
    assert np.all(interior[plan.b0:plan.b1]) and interior.sum() == plan.b1 - plan.b0


@pytest.mark.parametrize("name", list(K1_OFFSETS))
@pytest.mark.parametrize("itemsize", [4, 8])
def test_dia_plan_covers_every_row_once_and_splits_interior_blocks(name, itemsize):
    offsets = K1_OFFSETS[name]
    for n in K1_ROWS:
        plan = sk.dia_plan(offsets, n, n, itemsize)
        _check_dia_plan(plan, offsets, n, n, itemsize)
        # a launch of G blocks sweeps blocks g, g + G, ...: every block once
        for grid in {1, 3, 132, plan.n_blocks}:
            swept = np.sort(np.concatenate([np.arange(g, plan.n_blocks, grid)
                                            for g in range(min(grid, plan.n_blocks))]))
            np.testing.assert_array_equal(swept, np.arange(plan.n_blocks))
    # a rectangular operator: the columns bound the interior
    for n, n_cols in ((4099, 3000), (3000, 4099), (1_048_576, 1_040_000)):
        _check_dia_plan(sk.dia_plan(offsets, n, n_cols, itemsize), offsets, n, n_cols,
                        itemsize)


@pytest.mark.parametrize("lanes", range(1, 9))
def test_dia_plan_for_every_lane_count(lanes):
    # s <= 8 lanes are one launch on the narrowest compiled width that holds
    # them; residual mode sweeps K1's blocks whatever the lanes (so lane l's
    # sums are K1's on x_l, block for block), and the plain lane form's own
    # rows a thread cover every row once with the interior split right
    assert sk.lane_chunks(lanes) == [(0, lanes)]
    width = sk.lane_width(lanes)
    assert width in sk.LANE_WIDTHS and lanes <= width < 2 * lanes
    for name, offsets in K1_OFFSETS.items():
        for itemsize in (4, 8):
            assert sk.rows_per_thread(itemsize, width, residual=True) == 16 // itemsize
            rows = sk.rows_per_thread(itemsize, width)
            assert rows in (1, 2, 16 // itemsize) and (width > 1 or rows == 16 // itemsize)
            for n in K1_ROWS:
                one = sk.dia_plan(offsets, n, n, itemsize)
                assert one == sk.dia_plan(offsets, n, n, itemsize,
                                          sk.rows_per_thread(itemsize, width, residual=True))
                assert one == hk.halo_plan(offsets, n, 0, 0, itemsize)
                if name in ("convdiff", "random"):
                    _check_dia_plan(sk.dia_plan(offsets, n, n, itemsize, rows), offsets, n, n,
                                    itemsize, rows)


def test_dia_plan_at_convdiff_1m():
    # n = 1,048,576 with offsets +-1 and +-1024: the first and last 1024 rows
    # read outside x (fp32: one 1024-row block a side; fp64: two of 512)
    p32 = sk.dia_plan(CONVDIFF_1M, 1 << 20, 1 << 20, 4)
    p64 = sk.dia_plan(CONVDIFF_1M, 1 << 20, 1 << 20, 8)
    assert (p32.n_blocks, p32.b0, p32.b1) == (1024, 1, 1023)
    assert (p64.n_blocks, p64.b0, p64.b1) == (2048, 2, 2046)
    with pytest.raises(ValueError):
        sk.dia_plan(CONVDIFF_1M, 0, 1, 4)


@pytest.mark.parametrize("offsets,r,hl,hr", [
    (CONVDIFF_1M, 262_144, 1024, 1024),    # convdiff@1M over 4 ranks
    (CONVDIFF_1M, 262_144, 0, 1024),       # the first rank
    ((-3, -1, 0, 1, 3), 70_001, 3, 3),     # ragged r
    ((-2, -1, 0, 1, 2), 5000, 0, 0),       # no edges at all
    ((-1024, -1, 0, 1, 1024), 1000, 0, 0),  # r < max|off|: no interior block
    ((-1024, 0, 1024), 1500, 1024, 1024),  # edges wider than the shard
    ((0, 1, 2), 4097, 0, 2),               # one-sided bands
    ((-5, 0), 4097, 5, 0),
    ((0,), 1, 0, 0),                       # one row
    (tuple(range(-13, 14)), 3 * 1024 + 17, 13, 13),  # D = 27
])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_halo_plan_splits_rows_into_interior_and_window_blocks(offsets, r, hl, hr, itemsize):
    plan = hk.halo_plan(offsets, r, hl, hr, itemsize)
    assert plan.block_rows == 256 * 16 // itemsize
    assert plan.n_blocks == -(-r // plan.block_rows)
    assert 0 <= plan.b0 <= plan.b1 <= plan.n_blocks
    seen = np.zeros(r, dtype=np.int64)
    lo, hi = min(offsets), max(offsets)
    for b in range(plan.n_blocks):
        rows = plan.rows(b)
        assert len(rows) > 0
        seen[rows.start:rows.stop] += 1
        reads_past_x = rows.start + lo < 0 or rows.stop - 1 + hi >= r
        # interior rows read only x; a block takes the window path only
        # when one of its rows reads past x
        assert plan.interior(b) == (not reads_past_x)
    assert np.all(seen == 1)
    interior = [b for b in range(plan.n_blocks) if plan.interior(b)]
    assert interior == list(range(plan.b0, plan.b1))


def test_halo_plan_at_convdiff_1m_leaves_two_window_blocks_a_side():
    # r = 262,144 with offsets +-1 and +-1024: the first and last 1024 rows
    # read the edges (fp32: one 1024-row block a side; fp64: two of 512)
    p32 = hk.halo_plan(CONVDIFF_1M, 262_144, 1024, 1024, 4)
    p64 = hk.halo_plan(CONVDIFF_1M, 262_144, 1024, 1024, 8)
    assert (p32.n_blocks, p32.b0, p32.b1) == (256, 1, 255)
    assert (p64.n_blocks, p64.b0, p64.b1) == (512, 2, 510)


def test_df_update_gram_two_stages_fit_for_every_height():
    for rows in range(1, 257):
        plan = dk.df_update_gram_plan(1 << 20, rows, 132)
        assert plan.tile >= dk.DF_LINE and plan.tile % dk.DF_LINE == 0
        assert plan.tile <= dk.DF_MAX_TILE
        u_words = 2 * (-(-rows // 4) * 4)
        assert plan.shared_bytes == (2 * (2 * rows + 2) * plan.tile + u_words) * 4
        assert plan.shared_bytes <= dk.DF_SMEM_BUDGET
        per_block = plan.shared_bytes + dk.DF_STATIC_BYTES + ok.BLOCK_RESERVED_BYTES
        assert per_block <= 232_448  # a block's 227 KB
        assert 1 <= plan.blocks_per_sm <= dk.DF_BLOCKS_PER_SM
        assert plan.blocks_per_sm * per_block <= ok.SM_SHARED_BYTES
        # the widest such tile: one more line would not fit
        wider = (2 * (2 * rows + 2) * (plan.tile + dk.DF_LINE) + u_words) * 4
        assert plan.tile == dk.DF_MAX_TILE or wider > dk.DF_SMEM_BUDGET


@pytest.mark.parametrize("n", [1, 447, 70_001, 2 ** 20, 2 ** 20 + 3])
@pytest.mark.parametrize("rows", [1, 16, 31, 256])
def test_df_update_gram_plan_covers_every_column_once(n, rows):
    widest = dk.df_update_gram_plan(n, rows, 132).tile
    for sms, per_sm, tile in ((132, None, None), (132, 1, None), (7, 3, None),
                              (132, 2, 32), (132, None, min(96, widest))):
        plan = dk.df_update_gram_plan(n, rows, sms, per_sm, tile)
        assert tile is None or plan.tile == tile
        assert 1 <= plan.grid <= min(plan.n_tiles, sms * plan.blocks_per_sm)
        seen = np.zeros(n, dtype=np.int64)
        for b in range(plan.grid):
            for t in plan.tiles_of(b):
                cols = plan.columns(t)
                seen[cols.start:cols.stop] += 1
        assert np.all(seen == 1)


def test_df_update_gram_plan_refuses_tiles_the_kernel_does_not_take():
    for tile in (0, 16, 100, 4096):
        with pytest.raises(ValueError):
            dk.df_update_gram_plan(1 << 20, 31, 132, tile=tile)


@pytest.mark.parametrize("n", [1, 3, 1023, 1025, 2048, 70_001, 2 ** 20, 2 ** 20 + 3])
@pytest.mark.parametrize("itemsize", [4, 8, 2])
def test_gram2_plan_is_gram_plan(n, itemsize):
    # K2x2 walks K2's tiles (so each vector's tile partials, and then u, are
    # K2's), on a grid of GRAM2_BLOCKS_PER_SM blocks an SM
    k2 = ok.gram_plan(n, itemsize, 132)
    k2x2 = ok.gram_plan(n, itemsize, 132, ok.GRAM2_BLOCKS_PER_SM)
    assert (k2x2.tile, k2x2.n_tiles) == (k2.tile, k2.n_tiles) == (
        ok.GRAM_TILE, -(-n // ok.GRAM_TILE))
    assert [k2x2.columns(t) for t in range(k2.n_tiles)] == \
        [k2.columns(t) for t in range(k2.n_tiles)]
    assert k2x2.grid == min(k2.n_tiles, 132 * ok.GRAM2_BLOCKS_PER_SM)
    assert ok.GRAM2_BLOCKS_PER_SM < ok.GRAM_BLOCKS_PER_SM


# K4's forms: (basis, iterate) item sizes, by entry-point suffix
AXPY_SIZES = {sfx: (v.itemsize, x.itemsize) for (v, _, x), sfx in AXPY_FORMS.items()}


def _axpy_chunks(plan, t, thread):
    """The column ranges of ``thread``'s chunks in tile ``t`` (empty past n):
    chunk k at (k * threads + thread) * vec, one coalesced pass of the
    block each."""
    out = []
    for k in range(ou.AXPY_COLS // plan.vec):
        c = t * plan.tile + (k * plan.threads + thread) * plan.vec
        out.append(range(min(c, plan.n), min(c + plan.vec, plan.n)))
    return out


def _axpy_split(n, vec, phase):
    """How K4 reads the n values of one basis row whose first value lies
    ``phase`` values past a 16-byte boundary, in chunks of ``vec`` columns:
    a chunk is one 16-byte load where it starts 16-byte aligned and lies
    whole below n, else value by value.  Returns (the starts of the 16-byte
    loads, the columns read one by one).  The kernel's aligned form (n a
    multiple of vec, V and x 16-byte aligned) is the case with no column
    read alone; x is read and written 16 bytes at a time there, value by
    value otherwise."""
    starts = np.arange(0, n, vec)
    vector = (starts + vec <= n) & ((phase + starts) % vec == 0)
    rest = starts[~vector]
    cols = (rest[:, None] + np.arange(vec)).ravel()
    return starts[vector], cols[cols < n]


def _axpy_chunk_columns(plan):
    """Every thread chunk's columns, tile by tile as the grid takes them
    (chunk k of thread i at (k * threads + i) * vec in its tile)."""
    tiles = np.concatenate([np.arange(b, plan.n_tiles, plan.grid) for b in range(plan.grid)])
    k, i = np.divmod(np.arange(plan.tile // plan.vec), plan.threads)
    starts = (tiles[:, None] * plan.tile + (k * plan.threads + i) * plan.vec).ravel()
    cols = (starts[:, None] + np.arange(plan.vec)).ravel()
    return tiles, cols[cols < plan.n]


@pytest.mark.parametrize("n", [1, 7, 8, 9, 1023, 1025, 4099, 262_144])
@pytest.mark.parametrize("sfx", sorted(AXPY_SIZES))
def test_axpy_split_covers_every_column_once(n, sfx):
    itemsize, x_itemsize = AXPY_SIZES[sfx]
    vec = 16 // itemsize
    for sms, per_sm in ((132, ou.AXPY_BLOCKS_PER_SM), (132, 0), (7, 3)):
        plan = ou.axpy_plan(n, itemsize, sms, per_sm)
        assert plan.vec == vec and plan.tile == 256 * ou.AXPY_COLS
        tiles, cols = _axpy_chunk_columns(plan)
        assert np.array_equal(np.sort(tiles), np.arange(plan.n_tiles))
        assert np.array_equal(np.bincount(cols, minlength=n), np.ones(n, dtype=np.int64))
    for v_phase in range(vec):
        for x_phase in range(16 // x_itemsize):
            aligned = n % vec == 0 and v_phase == 0 and x_phase == 0
            for j in range(4):
                phase = (v_phase + j * n) % vec
                vector, scalar = _axpy_split(n, vec, phase)
                seen = np.bincount(np.concatenate([(vector[:, None] + np.arange(vec)).ravel(),
                                                   scalar]), minlength=n)
                assert np.array_equal(seen, np.ones(n, dtype=np.int64))
                assert np.all(vector % vec == 0) and np.all(vector + vec <= n)
                assert np.all((phase + vector) % vec == 0)  # 16-byte aligned loads
                if aligned:
                    # no value read alone; x's chunks are whole 16-byte chunks
                    assert scalar.size == 0 and vec * x_itemsize % 16 == 0
                elif phase:
                    assert vector.size == 0


def test_axpy_plan_grids():
    # the persistent grid holds AXPY_BLOCKS_PER_SM blocks an SM, no more
    # than there are tiles; 0 gives one block a tile; a thread owns
    # AXPY_COLS columns of a tile, in 16-byte chunks threads * vec apart
    plan = ou.axpy_plan(2 ** 22, 4, 132)
    assert (plan.vec, plan.tile, plan.n_tiles) == (4, 2048, 2048)
    assert plan.grid == 132 * ou.AXPY_BLOCKS_PER_SM
    assert ou.axpy_plan(2 ** 22, 4, 132, 0).grid == 2048
    assert ou.axpy_plan(2 ** 20, 8, 132).grid == ou.axpy_plan(2 ** 20, 8, 132, 0).grid == 512
    assert ou.axpy_plan(1000, 2, 132).grid == 1
    assert _axpy_chunks(ou.axpy_plan(4000, 8, 132), 1, 3) == [
        range(2048 + 6, 2048 + 8), range(2048 + 512 + 6, 2048 + 512 + 8),
        range(2048 + 1024 + 6, 2048 + 1024 + 8), range(2048 + 1536 + 6, 2048 + 1536 + 8)]
    assert _axpy_chunks(ou.axpy_plan(2100, 8, 132), 1, 26) == [range(2100, 2100)] * 4
    assert _axpy_chunks(ou.axpy_plan(2100, 8, 132), 1, 25) == [range(2098, 2100)] + [range(2100, 2100)] * 3
