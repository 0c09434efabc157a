"""Starting the ranks of a distributed solve (the counterpart of
``gmres_tpu/parallel/multihost.py:initialize``).

``solve_distributed`` is SPMD: every rank of a ``torch.distributed`` process
group calls it with the same arguments.  Ranks started by any launcher call
``init`` first.  ``spawn`` runs a module-level function on P ranks of this
host and returns what each rank returned:

    from gmres_tpu_torch.parallel import launch
    results = launch.spawn(fn, 4, args=(...,))     # fn(*args) on ranks 0..3

The spawned ranks use the spawn start method (a fresh interpreter each, so
``fn`` must be importable from its module) and meet through a ``file://``
rendezvous under a new temporary directory, so concurrent spawns never
collide on a port.  One rank per card needs NCCL and as many cards; on one
card, or on the CPU, the ranks use gloo (NCCL refuses two ranks on one
device).

``command_group`` gives a command line's ``--dist`` its group: the default
group when a launcher or ``spawn`` has initialized one, else one made for
the command (from a launcher's environment, or a one-rank gloo group in
this process).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init(backend: str = "gloo", rank: int | None = None, world_size: int | None = None,
         init_method: str | None = None, timeout: float = 300.0) -> None:
    """``torch.distributed.init_process_group`` with the rank, the world
    size and the rendezvous given explicitly (``init_method`` such as
    ``tcp://localhost:<port>`` or ``file:///path``); ``timeout`` bounds
    every collective, in seconds."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout))


@contextlib.contextmanager
def command_group(timeout: float = 300.0):
    """The default process group for the body of a ``with``: the one
    already initialized (by a launcher or ``spawn``), else one initialized
    here and destroyed at the end: from a launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; gloo, the
    card of ``LOCAL_RANK``) or, without one, a gloo group of one rank in
    this process (on the H100 machine's one card, or the CPU)."""
    if dist.is_initialized():
        yield
        return
    tmp = None
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo", init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout))
    else:
        tmp = tempfile.mkdtemp(prefix="gmres_tpu_torch_rdzv_")
        init("gloo", 0, 1, "file://" + os.path.join(tmp, "rendezvous"), timeout)
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank, world_size, init_method, timeout, threads, fn, args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        init("gloo", rank, world_size, init_method, timeout)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # pickled here by value: a tensor put on the queue as it is would be
        # shared through this process, which may be gone when it is read
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world_size: int, args: tuple = (), timeout: float = 300.0,
          threads: int | None = 1) -> list:
    """Run ``fn(*args)`` on ``world_size`` new gloo ranks of one process
    group and return the ranks' results in rank order.  ``threads`` sets
    ``torch.set_num_threads`` in each rank (None leaves it).  A rank that
    raises, or ranks still running after ``timeout`` seconds (also each
    collective's timeout), fail the call: the other ranks are stopped and
    ``RuntimeError`` is raised."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gmres_tpu_torch_rdzv_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, init_method, timeout, threads, fn, args,
                               results))
             for r in range(world_size)]
    started = []
    try:
        for p in procs:
            p.start()
            started.append(p)
        out = {}
        deadline = time.monotonic() + timeout
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"spawn: ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"still running after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank {dead[0]} died with exit code "
                                       f"{procs[dead[0]].exitcode}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return [out[r] for r in range(world_size)]
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
