"""Solver checkpoint and resume (``gmres_tpu/utils/checkpoint.py``).

Restarts are natural checkpoint boundaries: only x and the small policy
scalars survive one.  ``solve(..., checkpoint=CheckpointSpec(path))`` saves
(x, restart count, iteration count, policy state) every ``every`` restarts
and resumes from the file when it exists.  The file is an ``.npz`` with the
JAX package's keys and dtypes, so either package reads the other's file.

A bf16 solve that stalls and continues in fp32 has two phases, each with
its own file.  When the bf16 phase stalls, its file is saved once more with
the key ``stalled`` set (the JAX package ignores the key), holding the
stalled iterate and the bf16 phase's counts, and the fp32 continuation
starts from that iterate with its counts at zero and its own file,
``CheckpointSpec.continuation()``.  A bf16 solve that resumes a file marked
``stalled`` runs no bf16 cycle and goes straight to its continuation, which
resumes from its own file when there is one.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

from gmres_tpu_torch.solver.policies import PolicyState


@dataclasses.dataclass
class CheckpointSpec:
    path: str
    every: int = 10  # restarts between saves

    def continuation(self) -> "CheckpointSpec":
        """The file of the fp32 continuation of a stalled bf16 phase."""
        return dataclasses.replace(self, path=self.path + ".fp32")


def save(path: str, x, i: int, total_iters: int, pstate: PolicyState,
         stalled: bool = False) -> None:
    """Write to a temporary file in the same directory and rename it over
    ``path``, so that an interrupted save never leaves a broken file."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    extra = {"stalled": np.asarray(True)} if stalled else {}
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, x=x, i=np.int64(i), total_iters=np.int64(total_iters),
                     is_first=np.asarray(bool(pstate.is_first)),
                     second_restart_length=np.int32(pstate.second_restart_length),
                     restart_tol=np.float64(pstate.restart_tol), **extra)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_stalled(spec: CheckpointSpec, x, i: int, total_iters: int,
                 pstate: PolicyState) -> None:
    """End a phase that stalled: drop the file of an earlier continuation,
    then mark this phase's file ``stalled``."""
    if os.path.exists(spec.continuation().path):
        os.unlink(spec.continuation().path)
    save(spec.path, x, i, total_iters, pstate, stalled=True)


def load_phase(path: str):
    """(x as a numpy array, i, total_iters, PolicyState, stalled), or None
    when there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        pstate = PolicyState(is_first=bool(z["is_first"]),
                             second_restart_length=int(z["second_restart_length"]),
                             restart_tol=float(z["restart_tol"]))
        stalled = "stalled" in z.files and bool(z["stalled"])
        return z["x"], int(z["i"]), int(z["total_iters"]), pstate, stalled


def load(path: str):
    """(x as a numpy array, i, total_iters, PolicyState), or None when there
    is no file."""
    state = load_phase(path)
    return None if state is None else state[:4]
