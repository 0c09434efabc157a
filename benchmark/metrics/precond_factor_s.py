"""precond_factor_s (s; layer: host setup, ``precond/build.py:_factors``,
``csrc/ilu_host.cpp``): the host wall of the program's ``precond.factor``
span, the ILU(0) factorization on the host and the split of its
triangles, in a set-up of the cell made with the spans on after the
traced call (``spans.py``; the process's second).  Nothing to read in a
cell without an ILU preconditioner.  Moves ``setup_s``."""

from benchmark import spans


def read(run):
    c = spans.collect(run)
    d = [] if c is None else spans.seconds(c.setup, "precond.factor")
    return sum(d) if d else None
