"""stage_pack_s (s; layer: host setup, ``solver/gmres.py:stage`` ->
``_format``, ``ops/dia.py:from_csr``): the host wall of the program's
``stage.pack`` span, the CSR -> DIA repack on the host without the upload,
in a set-up of the cell made with the spans on after the traced call
(``spans.py``; the process's second, so its caches are warm).  Moves
``setup_s``."""

from benchmark import spans


def read(run):
    c = spans.collect(run)
    d = [] if c is None else spans.seconds(c.setup, "stage.pack")
    return sum(d) if d else None
