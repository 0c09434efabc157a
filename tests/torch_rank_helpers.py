"""Rank-side helpers of the distributed port tests.  Spawned ranks import
this module by name, so it imports no JAX (the test modules do)."""

import os
import shutil
import threading

import numpy as np
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
    solved with ``HiPartsComm`` in place of the port's Comm.  A case's
    ``files`` ops run first on the ranks they name: ``("copy", src, dst,
    rank)`` and ``("remove", path, rank)`` (checkpoint files between
    solves); a rank waits for every rank's ops before it solves."""
    import torch.distributed as dist

    out = []
    try:
        for case in cases:
            for op in case.get("files", ()):
                if op[-1] == dist.get_rank():
                    if op[0] == "copy":
                        shutil.copyfile(op[1], op[2])
                    elif os.path.exists(op[1]):
                        os.unlink(op[1])
            dist.barrier()
            dist_gmres.Comm = HiPartsComm if case.get("hi_parts") else comm_mod.Comm
            out += dist_gmres.run_cases([case], device)
    finally:
        dist_gmres.Comm = comm_mod.Comm
    return out


def run_mains(runs) -> list:
    """``main(argv)`` of each (module, argv) of port command lines on this
    rank, with its standard output captured: [(exit code, output)]."""
    import contextlib
    import importlib
    import io

    out = []
    for module, argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(module).main(argv)
        out.append((rc, buf.getvalue()))
    return out


def run_threaded(fn, n_ranks: int) -> list:
    """``fn(rank, exchange)`` on ``n_ranks`` threads of this process, each
    with an ``exchange`` that all-gathers a small host array over the
    threads, as ``parallel/multihost.py:exchange_host_array`` does over
    ranks (every thread must call it alike).  Returns the results in rank
    order; a thread's exception is raised."""
    barrier = threading.Barrier(n_ranks)
    slots, results, errors = [None] * n_ranks, [None] * n_ranks, []

    def exchange_for(rank):
        def exchange(arr):
            slots[rank] = np.asarray(arr)
            barrier.wait()
            out = np.stack(slots)
            barrier.wait()
            return out
        return exchange

    def body(rank):
        try:
            results[rank] = fn(rank, exchange_for(rank))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


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
