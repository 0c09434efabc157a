"""Benchmark matrix suites (``gmres_tpu/experiments/suites.py``).

The reference's scaling worklist (``large mats to test.txt``) names
SuiteSparse matrices up to 127M nnz; this environment has no network access,
so the suites are synthetic generators spanning the same structural classes
and sizes.  When SuiteSparse .mtx files are available (``MTXDIR``), the
named suites below mirror the paper's sets.
"""

from __future__ import annotations

# The paper's main suite (plots-and-data.ipynb cell 1) — used when .mtx
# files are present under MTXDIR.
PAPER_SUITE = [
    "1138_bus", "add32", "apache2", "atmosmodj", "cage13", "cage14",
    "CurlCurl_4", "ecology2", "G3_circuit", "language", "rajat31",
    "thermal2", "t2em", "tmt_unsym", "wang3", "Zhao1",
]

# The reference's extra large-matrix worklist (large mats to test.txt:1-14).
LARGE_SUITE = [
    "stokes", "ML_Geer", "HV15R", "cage15", "vas_stokes_4M", "circuit5M",
    "nv2", "Transport", "dgreen", "barrier2-11", "bbmat", "RM07R",
    "CoupCons3D", "TSOPF_RS_b2383",
]

# Synthetic equivalents (structure class x size), runnable offline.  Specs
# are accepted by the solve/sweep CLIs (--synth / mat argument).
SYNTH_SMALL = ["poisson2d:64", "poisson3d:16", "convdiff:64"]
SYNTH_MEDIUM = ["poisson2d:512", "poisson3d:64", "convdiff:512"]
SYNTH_LARGE = ["poisson2d:2048", "poisson3d:128", "convdiff:2048"]
# Restart-length sweep configuration of BASELINE.json config #4
RESTART_LENGTHS = [10, 30, 50, 100]


def suite(name: str) -> list[str]:
    return {
        "paper": PAPER_SUITE,
        "large": LARGE_SUITE,
        "synth-small": SYNTH_SMALL,
        "synth-medium": SYNTH_MEDIUM,
        "synth-large": SYNTH_LARGE,
    }[name]
