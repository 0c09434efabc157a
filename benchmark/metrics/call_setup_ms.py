"""call_setup_ms (ms; layer: call set-up, ``solver/gmres.py:solve``,
``solver/batched.py:solve_batched`` before the first cycle): the host wall
of the program's ``solve.prepare`` span, the preconditioner's format
passes, ``prepare_operators`` (the staged operator cast to the inner and
outer dtypes), M's move, b, x and the one-time norms, in the call made
after the traced call with the spans on and the profiler off
(``spans.py``).  Paid again by every call.  Moves ``solve_s``
(``solve_s.ilu0`` in the ILU cell)."""

from benchmark import spans


def read(run):
    c = spans.collect(run)
    d = [] if c is None else spans.seconds(c.added, "solve.prepare")
    return 1e3 * sum(d) if d else None
