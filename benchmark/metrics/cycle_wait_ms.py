"""cycle_wait_ms (ms; layer: restart driver, ``solver/gmres.py:
restart_cycle``, ``drive_restarts``; ``solver/batched.py``): the mean host
wall of a cycle's host read, the program's ``cycle.read`` span around its
one ``.tolist()`` (and the read after the last cycle), in the call made
after the traced call with the spans on and the profiler off
(``spans.py``): the host blocked while the card finishes the work it has
been given.  Moves ``solve_s`` (``solve_s.ilu0`` in the ILU cell)."""

from benchmark import spans


def read(run):
    c = spans.collect(run)
    return None if c is None else spans.mean_ms(c.added, "cycle.read")
