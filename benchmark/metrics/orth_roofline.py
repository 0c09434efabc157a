"""orth_roofline (%; layer: orthogonalization, ``ops/orth.py`` -> the CGSR
step): the bytes the traced call's CGSR steps need, over the published HBM
peak, over the device time of the basis sweeps they issue (K2
``basis_gram_kernel`` with one vector, K3 GRAM ``basis_update_gram``, K3
SUMSQ ``basis_update_kernel``).

Bytes a step, whatever implements it: the k rows of the basis read three
times (two Gram-Schmidt passes, the second needing the first's update) and
the vector read and written by each pass: K2 (k + 1) n, K3 GRAM (k + 2) n,
K3 SUMSQ (k + 2) n values (PERF.md section 6), (3k + 5) n values of the
Krylov loop's dtype, summed over every step of every cycle of every lane.
The dtype is the sweeps' basis type, their kernels' first template
argument; where the sweeps do not share one there is nothing to read.

Peak: 3.35 TB/s, NVIDIA's data sheet for the H100 SXM5 80 GB at 700 W; the
run prints the card's power limit.  Moves ``solve_s``."""

import re

PEAK_BYTES_PER_S = 3.35e12
PATTERN = re.compile(r"basis_gram_kernel<[^>]*,\s*1\s*>|basis_update_gram|basis_update_kernel")
BASIS_TYPE = re.compile(r"^(?:void )?\w+<\s*(float|double|__nv_bfloat16)\s*,")
WIDTH = {"float": 4, "double": 8, "__nv_bfloat16": 2}


def read(run):
    seconds, widths = 0.0, set()
    for name, start, end in run.events or ():
        if PATTERN.search(name):
            seconds += (end - start) * 1e-6
            m = BASIS_TYPE.search(name)
            if m:
                widths.add(WIDTH[m.group(1)])
    if not seconds or not run.cycles or len(widths) != 1:
        return None
    w = widths.pop()
    values = sum((3 * k * (k + 1) // 2 + 5 * k) * run.n for lane in run.cycles for k in lane)
    return 100.0 * values * w / PEAK_BYTES_PER_S / seconds
