"""Rank-side helpers of the distributed port tests.  Spawned ranks import
this module by name, so it imports no JAX (the test modules do)."""

import torch

from gmres_tpu_torch.parallel import comm as comm_mod
from gmres_tpu_torch.parallel import dist_gmres


class HiPartsComm(comm_mod.Comm):
    """A Comm whose fp64 sums over the ranks are those of the ranks' hi
    parts: each rank's fp64 partial rounded to fp32 and the partials added
    in fp32, what a plain sum of the df64 pairs' hi parts gives."""

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if t.dtype != torch.float64:
            return super().all_reduce_sum(t)
        return super().all_reduce_sum(t.to(torch.float32)).to(torch.float64)


def run_cases(cases, device="cpu") -> list:
    """``dist_gmres.run_cases`` for each case, a case with ``hi_parts`` set
    solved with ``HiPartsComm`` in place of the port's Comm."""
    out = []
    try:
        for case in cases:
            dist_gmres.Comm = HiPartsComm if case.get("hi_parts") else comm_mod.Comm
            out += dist_gmres.run_cases([case], device)
    finally:
        dist_gmres.Comm = comm_mod.Comm
    return out


def pair_sums(n: int, rows: int, seed: int, device: str = "cuda"):
    """The df64 gram u = V w of a seeded pair basis (rows x n, fp64 split
    into pairs) over this rank's block of columns, summed over the ranks by
    the port's Comm and by ``HiPartsComm``, beside the gram of the whole
    basis on this rank's device alone and the same sums over absolute
    values (the scale of their rounding; numpy fp64, each)."""
    import numpy as np
    import torch.distributed as dist

    from gmres_tpu_torch.ops import df64
    from gmres_tpu_torch.ops.eft import split_f64

    rank, size = dist.get_rank(), dist.get_world_size()
    rng = np.random.default_rng(seed)
    V = torch.tensor(rng.standard_normal((rows, n)), device=device)
    w = torch.tensor(rng.standard_normal(n), device=device)
    (Vh, Vl), (wh, wl) = split_f64(V), split_f64(w)
    cols = slice(rank * n // size, (rank + 1) * n // size)
    blocks = (Vh[:, cols].contiguous(), Vl[:, cols].contiguous(), wh[cols].contiguous(),
              wl[cols].contiguous())
    out = [df64.df_gram(*blocks, rows, comm) for comm in (comm_mod.Comm(), HiPartsComm())]
    whole = df64.df_gram(Vh, Vl, wh, wl, rows)
    return [t.cpu().numpy() for t in (*out, whole, torch.mv(V.abs(), w.abs()))]
