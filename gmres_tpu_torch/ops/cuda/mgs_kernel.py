"""K7 wrapper: the whole modified Gram-Schmidt recurrence of one Arnoldi
step in one cooperative launch (``csrc/basis_mgs.cu``), beside its plain
PyTorch version.

Replaces ``gmres_tpu/ops/pallas/orth_kernel.py``'s ``_mgs``:

    for j < rows:  h_j = <w, v_j>;  w <- w - h_j v_j

returning ``(h, w', ||w'||)``, h of the full (m+1,) length with zeros past
``rows``.  As for K2/K3, the solver passes ``rows = k + 1``: rows k+1..m of
the basis are still zero, and a zero row changes nothing in the recurrence.

Dtype forms as K2/K3's (``_build.SWEEP_FORMS``): h_j and the update of w run
in the accumulation dtype; under a bf16 w, w is rounded to bf16 after every
row (``orth_kernel.py:353``), so the next h_j and ||w'|| read the rounded w;
h and ||w'|| are returned in w's dtype.

``mgs_cuda`` takes CUDA tensors only and raises on anything the kernel does
not take or a refused launch; ``mgs_plain`` runs on any device and is what
the CPU path and the on-card comparisons use.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from gmres_tpu_torch.ops.cuda._build import acc_dtype, library
from gmres_tpu_torch.ops.cuda.orth_kernel import _count, _rows_ok, _sweep_args

# Blocks per SM of K7's cooperative grid (0 takes as many as are resident)
# and the way a row's partials are awaited (csrc/basis_mgs.cu: kSync, a
# grid.sync(); kPoll, reading the tagged slots until they are the row's), per
# accumulation dtype: one block an SM (8 register tiles) polling in fp32,
# two blocks an SM (4 tiles) at a grid.sync() in fp64, the fastest of each
# dtype at convdiff@1M on the H100 (PERF.md, section 6).  Either gives the
# same bits.
SYNC, POLL = 0, 1
BLOCKS_PER_SM = {torch.float32: 1, torch.float64: 2}
EXCHANGE = {torch.float32: POLL, torch.float64: SYNC}
# Largest number of kTile-column tiles a block keeps in registers (1, 2, 4
# or 8); 0 keeps w in device memory (the form the kernel takes past the
# register capacity of the resident grid).
MAX_REGISTER_TILES = 8
# A row's partials are those of fixed groups of tiles, at most MGS_SLOTS of
# them (csrc/basis_mgs.cu: kMgsSlots), published in tagged slots
MGS_SLOTS = 256
# epochs of the slots' tags: tag = epoch * 256 + row, epoch in [1, 2^24)
_EPOCHS = 1 << 24


def mgs_groups(n: int, tile: int = 1024, max_tiles: int = MAX_REGISTER_TILES):
    """(tiles per group, groups): the smallest power of two, at most
    ``max_tiles``, that leaves at most MGS_SLOTS groups of the n / tile
    tiles.  Both depend on n only, so a row's partials, and h, have the
    same bits on every grid."""
    n_tiles = -(-n // tile)
    g = 1
    while g < max_tiles and -(-n_tiles // g) > MGS_SLOTS:
        g *= 2
    return g, -(-n_tiles // g)


def group_columns(n: int, g: int, group: int, tile: int = 1024) -> range:
    """The columns of group g: its tiles' columns within [0, n)."""
    return range(min(g * group * tile, n), min((g + 1) * group * tile, n))


class _Slots:
    """A card's tagged slots: one 64-bit word (fp32) or two (fp64) for each
    (row, group), zeroed when made, and the epoch of the next launch.  A
    launch's tags (epoch * 256 + row) were never written before; when the
    epochs run out the words are zeroed again.  One set a card: K7 launches
    on one stream at a time."""

    def __init__(self):
        self.words = None
        self.epoch = 1

    def take(self, device, n_words: int):
        """(the words, the launch's first tag)."""
        if self.words is None or self.words.numel() < n_words:
            self.words = torch.zeros(n_words, dtype=torch.int64, device=device)
            self.epoch = 1
        elif self.epoch >= _EPOCHS:
            self.words.zero_()
            self.epoch = 1
        tag0 = self.epoch << 8
        self.epoch += 1
        return self.words, tag0


_SLOTS: dict = {}


def mgs_plain(V: torch.Tensor, w: torch.Tensor, rows: int):
    """The row loop of ``gmres_tpu/ops/orth.py:mgs`` in torch ops, with the
    TPU kernel's dtypes (``orth_kernel.py:_mgs_kernel``): h_j and w's update
    in the accumulation dtype, a bf16 w rounded after every row."""
    _rows_ok(V, rows)
    acc = acc_dtype(w.dtype)
    h = torch.zeros(V.shape[0], dtype=acc, device=V.device)
    wa = w.to(acc, copy=True)
    for j in range(rows):
        vj = V[j].to(acc)
        hj = torch.dot(wa, vj)
        wa -= hj * vj
        if w.dtype != acc:
            wa = wa.to(w.dtype).to(acc)
        h[j] = hj
    return h.to(w.dtype), wa.to(w.dtype), torch.sqrt(torch.dot(wa, wa)).to(w.dtype)


def mgs_cuda(V: torch.Tensor, w: torch.Tensor, rows: int, blocks_per_sm: int | None = None,
             max_register_tiles: int = MAX_REGISTER_TILES, exchange: int | None = None):
    """K7: one cooperative launch (h, w' and ||w'||); ``blocks_per_sm`` and
    ``exchange`` override the dtype's BLOCKS_PER_SM and EXCHANGE.  The grid
    it ran on is left in ``mgs_cuda.grid`` as (blocks, register tiles per
    block)."""
    lib, sfx, m1, n, _ = _sweep_args("basis_mgs", V, rows, w=(w, V.shape[1]))
    acc = acc_dtype(w.dtype)
    per_sm = BLOCKS_PER_SM[acc] if blocks_per_sm is None else blocks_per_sm
    exchange = EXCHANGE[acc] if exchange is None else exchange
    if per_sm < 0 or max_register_tiles < 0 or exchange not in (SYNC, POLL):
        raise ValueError(f"basis_mgs: blocks_per_sm={per_sm}, "
                         f"max_register_tiles={max_register_tiles}, exchange={exchange}")
    group, n_groups = mgs_groups(n, lib.tile)
    slots, tag0 = _SLOTS.setdefault(V.device, _Slots()).take(
        V.device, (rows + 1) * n_groups * (acc.itemsize // 4))
    hn = torch.empty(m1 + 1, dtype=w.dtype, device=V.device)  # h, then ||w'||
    w_out = torch.empty_like(w)
    blocks, tiles = ctypes.c_int(0), ctypes.c_int(0)
    lib.call(f"gmres_basis_mgs_{sfx}", V.data_ptr(), w.data_ptr(), w_out.data_ptr(),
             hn.data_ptr(), slots.data_ptr(), n, rows, m1, group, n_groups, tag0, per_sm,
             max_register_tiles, exchange, ctypes.addressof(blocks), ctypes.addressof(tiles))
    _count(mgs_cuda, sfx)
    mgs_cuda.grid = (blocks.value, tiles.value)
    return hn[:m1], w_out, hn[m1]


mgs_cuda.launches = 0
mgs_cuda.forms = Counter()
mgs_cuda.grid = (0, 0)


def mgs(V, w, rows: int):
    return mgs_cuda(V, w, rows) if V.is_cuda else mgs_plain(V, w, rows)


def grid_sync_probe(blocks: int, syncs: int) -> None:
    """Launch a cooperative grid of ``blocks`` blocks that does ``syncs``
    grid-wide barriers and nothing else (for timing one barrier)."""
    library().call("gmres_grid_sync_probe", blocks, syncs)
