"""device_idle (%; layer: device): 1 - (the traced call's device busy time
an Arnoldi step, the union of its operations' intervals) / (the untraced
window's wall an Arnoldi step), as a percentage.  The busy time comes from
the trace and the wall from the untraced window, since the profiler slows
the host.  Moves ``solve_s``."""

from benchmark.harness import loop_steps
from benchmark.trace import busy_us


def read(run):
    if not run.events or not run.cycles:
        return None
    busy_per_step = busy_us(run.events) * 1e-6 / loop_steps(run.cycles)
    wall_per_step = run.window_s / sum(c["steps"] for c in run.calls)
    return 100.0 * (1.0 - busy_per_step / wall_per_step)
