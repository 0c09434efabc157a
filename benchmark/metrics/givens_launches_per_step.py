"""givens_launches_per_step (kernels; layer: Givens and policy, host
enqueue, ``ops/givens.py``, ``ops/tri.py``, ``solver/gmres.py``): the
device kernels of a traced call (copies and memsets left out, as
``kernels_per_step`` counts) launched inside the program's ``step.givens``
spans (the rotation of the new column, ``rotg``, ``accumulate_rotation``,
``kdim``/``bd``, the residual proxy and the policy trigger), over the
call's Arnoldi steps, a batched call's lanes stepping together.  A kernel
belongs to the innermost span open at the host time of its CUDA runtime
launch record, joined to the kernel by correlation id (``spans.py``); the
call is traced with the spans on.  Moves ``solve_s`` (``solve_s.ilu0`` in
the ILU cell)."""

from benchmark import spans


def read(run):
    c = spans.collect(run)
    if c is None or not any(k[3] is not None for k in c.kernels):
        return None
    layers = spans.layer_of(c.traced, c.kernels)
    n = sum(spans.is_kernel(k[0]) and layer == "step.givens"
            for k, layer in zip(c.kernels, layers))
    return n / c.loop_steps
