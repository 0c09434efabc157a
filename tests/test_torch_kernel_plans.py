"""The launch geometry of the redesigned K3 GRAM and K7, on the CPU (no
kernel runs here; the card tests hold the kernels themselves).

- ``update_gram_plan`` (K3 GRAM in fp32, ``csrc/basis_sweep.cu``): its
  tiles cover every column exactly once over the persistent grid, its tile
  is a whole number of 128-byte lines, and its two stages (each the tile's
  rows and w's tile) and u fit the per-block budget, for every rows in
  1..256.
- ``mgs_groups`` (K7, ``csrc/basis_mgs.cu``): a row's partials are those
  of fixed groups of tiles that depend on n only; the groups cover every
  column once, and every register tiling and grid-stride grid the kernel
  may take hands each group to exactly one block, so h has the same bits
  on every grid; the tags of its slots are new at every launch.
"""

import numpy as np
import pytest
import torch

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
