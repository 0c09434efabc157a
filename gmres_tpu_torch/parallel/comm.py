"""The collectives of a distributed solve over a ``torch.distributed`` group:
the port's counterpart of the JAX package's mesh axis.

Three operations, where the JAX package uses ``psum``, ``all_gather`` and
neighbour ``ppermute``s inside ``shard_map``:

- ``all_reduce_sum(t)``: the elementwise sum of ``t`` over the ranks;
- ``all_gather(x_local)``: the ranks' blocks concatenated in rank order
  (``gmres_tpu/ops/spmv.py:gather_operand``);
- ``exchange_halos(x_local, hl, hr)``: rank s receives the last ``hl``
  values of rank s-1 and the first ``hr`` of rank s+1; the first and last
  ranks receive zeros on their open side (``gmres_tpu/parallel/halo.py:
  394-422``).

Every rank must read bit-identical scalars: the host loop of a solve
branches on them, and ranks that disagree would issue different
collectives and deadlock.  So the sum is not left to the backend's
reduction order: each rank gathers every rank's partial and adds them in
rank order itself.  The payloads are small (at most a basis height of
partials a reduction), so the gather costs what an all_reduce would.  The
partials are added in the accumulation dtype (fp32 for bf16 partials, the
partials' own dtype otherwise) and the sum rounded back once: a bf16 sum
over the ranks never rounds at each add.  fp64 partials (the df64 tier's
pair sums among them) are added in fp64.

A bf16 payload moves as its bytes, viewed as uint8 (exact, and half the
bytes of a detour through fp32), so no backend's bf16 support is needed
(gloo refuses int16).

Under the gloo backend a CUDA payload is staged through a host tensor (gloo
has no point-to-point for device tensors), and the result is copied back
to the payload's device.  The operations block until the data has arrived.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """Collectives over ``group`` (None: the default process group)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "torch.distributed is not initialized: call "
                "gmres_tpu_torch.parallel.launch.init (or init_process_group) on every rank "
                "first, or run the ranks with launch.spawn")
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._host = dist.get_backend(group) == "gloo"

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor a collective runs on: a host copy under gloo."""
        return t.cpu() if self._host else t

    def _global_rank(self, rank: int) -> int:
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, added in rank order in the
        accumulation dtype and rounded to ``t``'s dtype, on ``t``'s device
        (a new tensor)."""
        parts = self._gather(t.reshape(-1))
        acc = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
        total = parts[0].to(acc, copy=True)
        for p in parts[1:]:
            total += p.to(acc)
        return total.to(t.dtype).reshape(t.shape).to(t.device)

    def _gather(self, t: torch.Tensor) -> list:
        src = _wire(self._out(t.contiguous()))
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return [p.view(t.dtype) for p in parts]

    def all_gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks in rank order, on ``x_local``'s device."""
        if self.size == 1:
            return x_local
        return torch.cat(self._gather(x_local)).to(x_local.device)

    def exchange_halos(self, x_local: torch.Tensor, hl: int, hr: int):
        """(left, right): the last ``hl`` values of rank s-1 and the first
        ``hr`` of rank s+1 (zeros past the first and last ranks), on
        ``x_local``'s device."""
        src = self._out(x_local)
        left = torch.zeros(hl, dtype=src.dtype, device=src.device)
        right = torch.zeros(hr, dtype=src.dtype, device=src.device)
        s, P = self.rank, self.size
        ops = []
        if hl and s + 1 < P:  # my tail is rank s+1's left halo
            ops.append(dist.P2POp(dist.isend, _wire(src[-hl:].contiguous()),
                                  self._global_rank(s + 1), self.group, tag=0))
        if hl and s > 0:
            ops.append(dist.P2POp(dist.irecv, _wire(left), self._global_rank(s - 1), self.group,
                                  tag=0))
        if hr and s > 0:  # my head is rank s-1's right halo
            ops.append(dist.P2POp(dist.isend, _wire(src[:hr].contiguous()),
                                  self._global_rank(s - 1), self.group, tag=1))
        if hr and s + 1 < P:
            ops.append(dist.P2POp(dist.irecv, _wire(right), self._global_rank(s + 1), self.group,
                                  tag=1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return left.to(x_local.device), right.to(x_local.device)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective moves (a view of ``t``'s memory): a bf16
    one as its bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
