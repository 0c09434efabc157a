"""iters_per_rhs (iters; layer: restart driver,
``solver/gmres.py:drive_restarts``): ``GmresResult.total_iters`` averaged
over every right-hand side of the untraced window, a count.  Moves
``solve_s``."""


def read(run):
    iters = [it for c in run.calls for it in c["iters"]]
    return sum(iters) / len(iters) if iters else None
