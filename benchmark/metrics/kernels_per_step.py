"""kernels_per_step (kernels; layer: Givens and policy, host enqueue,
``ops/givens.py``, ``ops/tri.py``, ``solver/gmres.py:_inner_cycle``): the
device kernels of the traced call (copies and memsets left out) over its
Arnoldi steps, the call's own set-up and outer residuals included (a
batched call's steps are its loop's, every lane together).  Moves
``solve_s``."""

from benchmark.harness import loop_steps


def read(run):
    if not run.events or not run.cycles:
        return None
    kernels = sum(not name.startswith(("Memcpy", "Memset")) for name, _, _ in run.events)
    return kernels / loop_steps(run.cycles)
