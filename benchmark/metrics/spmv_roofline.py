"""spmv_roofline (%; layer: inner SpMV, ``ops/spmv.py`` -> K1
``dia_spmv_kernel``, its lane form in a batched cell): the bytes K1's
launches in the traced call need, over the published HBM peak, over their
device time.

Bytes a launch, inputs read once and outputs written once (PERF.md section
6), with D the operator's distinct diagonals, n its rows, L the lanes of
the launch and w the bytes of its value type: a plain launch (D + 2L) n w
(the bands, x, y), a residual launch (D + 3L) n 8 (the float64 bands, x, b,
r).  A launch's value type, mode and lanes are read from its kernel's
template arguments ``dia_spmv_kernel<T, RESIDUAL, aligned, L>``; the lane
count is the compiled one, which is every live lane in the traced call
(all of a batched call's lanes live through its cycles but the last).

Peak: 3.35 TB/s, NVIDIA's data sheet for the H100 SXM5 80 GB at 700 W; the
run prints the card's power limit.  The share is bound by bytes: an SpMV
does 2 operations a stored value, far under the peak rate.  Moves
``solve_s``."""

import re

PEAK_BYTES_PER_S = 3.35e12
PATTERN = re.compile(r"dia_spmv_kernel<\s*(float|double)\s*,\s*(\w+)\s*,\s*\w+\s*,\s*(\d+)\s*>")
WIDTH = {"float": 4, "double": 8}


def read(run):
    need = seconds = 0.0
    for name, start, end in run.events or ():
        m = PATTERN.search(name)
        if not m:
            continue
        w, residual, lanes = WIDTH[m.group(1)], m.group(2) in ("true", "1"), int(m.group(3))
        if residual:
            need += (run.diagonals + 3 * lanes) * run.n * 8
        else:
            need += (run.diagonals + 2 * lanes) * run.n * w
        seconds += (end - start) * 1e-6
    return 100.0 * need / PEAK_BYTES_PER_S / seconds if seconds else None
