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
- ``halo_plan`` (K12, ``csrc/dia_halo.cu``): every row of the shard lies in
  one block, each block interior or on the window path; an interior row
  reads only x for every band, and a block takes the window path only when
  one of its rows reads past x.
- ``df_update_gram_plan`` (K10, ``csrc/df64_sweep.cu``): its two stages
  (each the tile's rows of Vh and Vl and w's pair) and u fit the per-block
  budget for every rows in 1..256, and its tiles cover every column exactly
  once over the persistent grid.
"""

import numpy as np
import pytest
import torch

from gmres_tpu_torch.ops.cuda import df64_orth_kernel as dk
from gmres_tpu_torch.ops.cuda import halo_kernel as hk
from gmres_tpu_torch.ops.cuda import mgs_kernel as mk
from gmres_tpu_torch.ops.cuda import orth_kernel as ok


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
