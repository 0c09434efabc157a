"""K7 wrapper: the whole modified Gram-Schmidt recurrence of one Arnoldi
step in one cooperative launch (``csrc/basis_mgs.cu``), beside its plain
PyTorch version.

Replaces ``gmres_tpu/ops/pallas/orth_kernel.py``'s ``_mgs``:

    for j < rows:  h_j = <w, v_j>;  w <- w - h_j v_j

returning ``(h, w', ||w'||)``, h of the full (m+1,) length with zeros past
``rows``.  As for K2/K3, the solver passes ``rows = k + 1``: rows k+1..m of
the basis are still zero, and a zero row changes nothing in the recurrence.

``mgs_cuda`` takes CUDA tensors only and raises on anything the kernel does
not take or a refused launch; ``mgs_plain`` runs on any device and is what
the CPU path and the on-card comparisons use.
"""

from __future__ import annotations

import ctypes

import torch

from gmres_tpu_torch.ops.cuda._build import library
from gmres_tpu_torch.ops.cuda.orth_kernel import _rows_ok, _sweep_args

# Blocks per SM of K7's cooperative grid (0 takes as many as are resident):
# one block per SM, each holding up to 8 tiles in registers, was the
# fastest grid at convdiff@1M in fp32 and fp64 on the H100 (PERF.md, PR 4).
BLOCKS_PER_SM = 1
# Largest number of kTile-column tiles a block keeps in registers (1, 2, 4
# or 8); 0 keeps w in device memory (the form the kernel takes past the
# register capacity of the resident grid).
MAX_REGISTER_TILES = 8


def mgs_plain(V: torch.Tensor, w: torch.Tensor, rows: int):
    """The row loop of ``gmres_tpu/ops/orth.py:mgs`` in torch ops."""
    _rows_ok(V, rows)
    h = torch.zeros(V.shape[0], dtype=V.dtype, device=V.device)
    w = w.clone()
    for j in range(rows):
        hj = torch.dot(w, V[j])
        w -= hj * V[j]
        h[j] = hj
    return h, w, torch.sqrt(torch.dot(w, w))


def mgs_cuda(V: torch.Tensor, w: torch.Tensor, rows: int, blocks_per_sm: int | None = None,
             max_register_tiles: int = MAX_REGISTER_TILES):
    """K7: one cooperative launch; the grid it ran on is left in
    ``mgs_cuda.grid`` as (blocks, register tiles per block)."""
    lib, sfx, m1, n, _ = _sweep_args("basis_mgs", V, rows, w=(w, V.shape[1]))
    per_sm = BLOCKS_PER_SM if blocks_per_sm is None else blocks_per_sm
    if per_sm < 0 or max_register_tiles < 0:
        raise ValueError(f"basis_mgs: blocks_per_sm={per_sm}, "
                         f"max_register_tiles={max_register_tiles}")
    n_tiles = -(-n // lib.tile)
    h = torch.empty(m1, dtype=V.dtype, device=V.device)
    w_out = torch.empty_like(w)
    partials = torch.empty((rows, n_tiles), dtype=V.dtype, device=V.device)
    ss = torch.empty(n_tiles, dtype=V.dtype, device=V.device)
    blocks, tiles = ctypes.c_int(0), ctypes.c_int(0)
    lib.call(f"gmres_basis_mgs_{sfx}", V.data_ptr(), w.data_ptr(), w_out.data_ptr(),
             h.data_ptr(), partials.data_ptr(), ss.data_ptr(), n, rows, m1, per_sm,
             max_register_tiles, ctypes.addressof(blocks), ctypes.addressof(tiles))
    mgs_cuda.launches += 1
    mgs_cuda.grid = (blocks.value, tiles.value)
    return h, w_out, torch.sqrt(ss.sum())


mgs_cuda.launches = 0
mgs_cuda.grid = (0, 0)


def mgs(V, w, rows: int):
    return mgs_cuda(V, w, rows) if V.is_cuda else mgs_plain(V, w, rows)


def grid_sync_probe(blocks: int, syncs: int) -> None:
    """Launch a cooperative grid of ``blocks`` blocks that does ``syncs``
    grid-wide barriers and nothing else (for timing one barrier)."""
    library().call("gmres_grid_sync_probe", blocks, syncs)
