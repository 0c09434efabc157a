"""precond_apply_ms (ms; layer: preconditioner apply, ``precond/apply.py``
-> K6): the device time of a K6 launch (``ilu_levels_kernel``, the exact
ILU(0) triangular solves on their level schedule), averaged over the
traced call's launches.  Moves ``solve_s``."""

import re

PATTERN = re.compile(r"ilu_levels_kernel")


def read(run):
    times = [end - start for name, start, end in run.events or () if PATTERN.search(name)]
    return sum(times) / len(times) * 1e-3 if times else None
