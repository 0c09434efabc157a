"""The host metadata exchange of per-host partitioning
(``gmres_tpu/parallel/multihost.py``).

The JAX package runs one process per host over a mesh that spans them;
the port runs one process per rank, so a rank's owned shards are
``{rank}`` and the "hosts" are the ranks of the group.  What the two
share is the metadata protocol: the per-host partitioners
(``parallel/halo.py``, ``precond/bilu.py``, ``precond/build.py:
build_jacobi_rowblock``) scan only their own rows and combine small
fixed-shape partials (offset sets, widths, maxima) through
``exchange_host_array``, every rank calling it the same number of times in
the same order.  Starting the ranks is ``parallel/launch.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def pack_offsets(offs, max_count: int) -> np.ndarray:
    """Fixed-shape wire format for a cross-rank set-union vote: a
    ``(max_count + 1,)`` int64 array ``[count, sorted values..., pad]``
    with ``count = -1`` signalling local overflow (> max_count values)."""
    arr = np.full(max_count + 1, np.iinfo(np.int64).min, np.int64)
    if len(offs) > max_count:
        arr[0] = -1
    else:
        arr[0] = len(offs)
        arr[1:1 + len(offs)] = sorted(offs)
    return arr


def union_offsets(rows: np.ndarray, max_count: int):
    """Union the gathered ``pack_offsets`` payloads; None when any rank
    overflowed or the union itself exceeds ``max_count``."""
    rows = np.asarray(rows)
    if (rows[:, 0] < 0).any():
        return None
    union: set[int] = set()
    for row in rows:
        union.update(int(o) for o in row[1:1 + int(row[0])])
    return union if len(union) <= max_count else None


def exchange_host_array(arr: np.ndarray, group=None) -> np.ndarray:
    """All-gather a small fixed-shape host array over the ranks of
    ``group`` (the default process group when None; gloo, whose
    collectives take CPU tensors): the ``(size,) + arr.shape`` stack, in
    rank order.  Without an initialized group, or in a group of one, the
    leading axis is 1 and no collective runs."""
    arr = np.ascontiguousarray(arr)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return arr[None]
    t = torch.from_numpy(arr.copy())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).numpy()
