"""host_ms_per_step (ms; layer: Givens and policy, host enqueue,
``solver/gmres.py:_inner_cycle``): the mean host wall of an Arnoldi step,
the program's ``step`` span, from the host's enqueue of the step's SpMV to
the end of its Givens and policy tail, in the call made after the traced
call with the spans on and the profiler off (``spans.py``).  Where it
exceeds the device's time a step, the host paces the cell.  Moves
``solve_s`` (``solve_s.ilu0`` in the ILU cell)."""

from benchmark import spans


def read(run):
    c = spans.collect(run)
    return None if c is None else spans.mean_ms(c.added, "step")
