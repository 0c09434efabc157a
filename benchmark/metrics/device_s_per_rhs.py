"""device_s_per_rhs (s; layer: device): the traced call's device busy time
(the union of its operations' intervals) over the right-hand sides it
solved.  The device's share of ``solve_s``, steadier than the wall where
the host paces a cell.  Moves ``solve_s``."""

from benchmark.trace import busy_us


def read(run):
    if not run.events or not run.cycles:
        return None
    return busy_us(run.events) * 1e-6 / len(run.cycles)
